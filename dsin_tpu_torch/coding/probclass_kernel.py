"""One fused wavefront front of the probclass context model on the card
(counterpart of the JAX package's `coding/probclass_pallas.py`, K3).

The CUDA kernel is `csrc/probclass_front.cu` (its header gives the design
and its bound); this module builds it with `nvcc` at first use
(`native_build`), binds it with `ctypes`, and holds:

* `probclass_front_logits(blocks, weights)`: (B, 5, 9, 9) float32 context
  blocks -> (B, L) float32 logits through the four masked convs. A CUDA
  tensor launches the kernel or raises; a CPU tensor takes the plain
  version, and only a CPU tensor does;
* `probclass_front_logits_reference`, the same function in plain torch: the
  static tap loop of matmuls of the Pallas kernel's `_conv_taps`;
* `ProbclassFrontKernel`, the weight-holding wrapper codec mode 3 uses.

`weights` are the four pre-masked (W (taps*Cin, Cout), b (Cout,)) pairs of
`models/probclass.front_weight_matrices`, as tensors on the blocks' device.
The wrapper counts its launches in `launch_counts`.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from dsin_tpu_torch import native_build
from dsin_tpu_torch.models import probclass as pc_lib

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "probclass_front.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SIZE = 3                            # the kernel's fixed filter geometry
CONTEXT = pc_lib.context_shape(KERNEL_SIZE)          # (5, 9, 9)
FILTER = pc_lib.filter_shape(KERNEL_SIZE)            # (2, 3, 3)

# one count per wrapper call that launches the kernel; never incremented by
# the plain version
launch_counts = {"probclass_front_logits": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class KernelLibrary(NamedTuple):
    front: Callable            # probclass_front_logits
    error_string: Callable
    path: str
    build_seconds: float       # 0.0 when the library was already built
    ptxas_log: str             # nvcc -Xptxas -v output of this build


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build `csrc/probclass_front.cu` into `build/` (keyed by a hash of the
    source and flags) unless already built, and bind it. Raises on
    failure."""
    so, seconds, log = native_build.build(SOURCE, native_build.nvcc(),
                                          NVCC_FLAGS, "probclass_front")
    lib = ctypes.CDLL(str(so))
    front = lib.probclass_front_logits
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    front.argtypes = [ptr] * 10 + [i32, i32, i32, ptr]
    front.restype = i32
    err_str = lib.probclass_front_error_string
    err_str.argtypes = [i32]
    err_str.restype = ctypes.c_char_p
    return KernelLibrary(front, err_str, str(so), seconds, log)


def _check(blocks: torch.Tensor, weights) -> Tuple[int, int]:
    """Raise on what the kernel does not take; -> (C, L)."""
    if len(weights) != 4:
        raise ValueError(f"expected 4 (W, b) pairs, got {len(weights)}")
    taps = int(np.prod(FILTER))
    c = weights[0][0].shape[1]
    cins = (1, c, c, c)
    for i, ((w, b), cin) in enumerate(zip(weights, cins)):
        cout = w.shape[1] if w.dim() == 2 else -1
        if tuple(w.shape) != (taps * cin, cout) or tuple(b.shape) != (cout,):
            raise ValueError(f"layer {i}: W {tuple(w.shape)} / b "
                             f"{tuple(b.shape)}, expected ({taps * cin}, "
                             f"Cout) / (Cout,)")
        if i < 3 and cout != c:
            raise ValueError(f"layer {i} has {cout} outputs, conv0 has {c}")
    tensors = [blocks] + [t for pair in weights for t in pair]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{t.dtype} operand: the probclass front kernel "
                            "takes float32 only (entropy path)")
        if t.device != blocks.device:
            raise ValueError(f"operand on {t.device}, blocks on "
                             f"{blocks.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if blocks.dim() != 4 or tuple(blocks.shape[1:]) != CONTEXT:
        raise ValueError(f"blocks {tuple(blocks.shape)}, expected (B,) + "
                         f"{CONTEXT}: the kernel is built for kernel_size "
                         f"{KERNEL_SIZE}")
    return c, weights[3][0].shape[1]


def probclass_front_logits(blocks: torch.Tensor,
                           weights: Sequence[Tuple[torch.Tensor,
                                                   torch.Tensor]]):
    """(B, 5, 9, 9) float32 context blocks -> (B, L) float32 logits."""
    c, l_out = _check(blocks, weights)
    if blocks.device.type == "cpu":
        return probclass_front_logits_reference(blocks, weights)
    if blocks.device.type != "cuda":
        raise ValueError(f"the probclass front kernel runs on CUDA tensors, "
                         f"got {blocks.device}")
    lib = load_library()
    b = blocks.shape[0]
    out = torch.empty((b, l_out), dtype=torch.float32, device=blocks.device)
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        err = lib.front(blocks.data_ptr(),
                        *[t.data_ptr() for pair in weights for t in pair],
                        out.data_ptr(), b, c, l_out, stream)
    if err != 0:
        raise RuntimeError(f"probclass_front_logits launch failed: CUDA "
                           f"error {err} ({lib.error_string(err).decode()})")
    launch_counts["probclass_front_logits"] += 1
    return out


def _conv_taps(act: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """VALID masked conv as a static tap loop: act (B, D, H, W, Cin), w
    (taps*Cin, Cout) in (td, th, tw) row-major tap order."""
    bsz, d, h, wd, cin = act.shape
    fd, fh, fw = FILTER
    do, ho, wo = d - fd + 1, h - fh + 1, wd - fw + 1
    acc = torch.zeros((bsz * do * ho * wo, w.shape[1]), dtype=act.dtype,
                      device=act.device)
    tap = 0
    for td in range(fd):
        for th in range(fh):
            for tw in range(fw):
                sl = act[:, td:td + do, th:th + ho, tw:tw + wo, :]
                acc = acc + sl.reshape(-1, cin) @ w[tap * cin:(tap + 1) * cin]
                tap += 1
    return (acc + b).reshape(bsz, do, ho, wo, -1)


def probclass_front_logits_reference(blocks: torch.Tensor, weights):
    """The kernel's function in plain torch (the Pallas `_front_kernel`):
    conv0+ReLU, conv1+ReLU, conv2 + the cropped act1 skip, conv3+ReLU."""
    (w0, b0), (w1, b1), (w2, b2), (w3, b3) = weights
    act1 = torch.relu(_conv_taps(blocks[..., None], w0, b0))
    r1 = torch.relu(_conv_taps(act1, w1, b1))
    dd, hw = 2 * (KERNEL_SIZE // 2), KERNEL_SIZE - 1
    act3 = _conv_taps(r1, w2, b2) + act1[:, dd:, hw:-hw, hw:-hw, :]
    return torch.relu(_conv_taps(act3, w3, b3)).reshape(blocks.shape[0], -1)


class ProbclassFrontKernel:
    """Codec mode 3's engine: the pre-masked weights on `device`, and
    `front_logits(blocks) -> (B, L) float32 numpy` through
    `probclass_front_logits`. Read-only after construction."""

    def __init__(self, weights, device: torch.device):
        self.device = device
        self.weights = [(torch.as_tensor(w, device=device),
                         torch.as_tensor(b, device=device))
                        for w, b in weights]

    def front_logits(self, blocks: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(blocks, np.float32))
        return probclass_front_logits(x.to(self.device),
                                      self.weights).cpu().numpy()
