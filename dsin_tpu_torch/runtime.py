"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import os

import torch

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on, with IEEE fp32 numerics.

    Defaults to the card and raises when no card is present: only an explicit
    ``device="cpu"`` runs on the CPU. Turns TF32 off for cuDNN convolutions
    and cuBLAS products, because the fp32 rung is IEEE fp32 in the reference
    and cuDNN convolutions default to TF32. Pins cuDNN to deterministic
    algorithms: by default the decoder's transposed convolutions may pick an
    algorithm that sums in another order from call to call, and then equal
    symbols decode to images that differ in the last bits."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return dev


def config_path(name: str) -> str:
    """Path of a configuration file bundled with the port (`configs/`)."""
    return os.path.join(CONFIG_DIR, name)
