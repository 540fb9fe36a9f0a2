"""Model and codec construction for the codec's entry points (counterpart of
the JAX package's `coding/loader.py:28-133`).

`load_model_state` builds the port's DSIN from its own seeded init
(`models/dsin.build_model`); `make_codec` is the one `BottleneckCodec`
construction the call sites share. The port's modules are fully
convolutional and eager, so no image shape is needed to build them.
Restoring a checkpoint is not ported yet: the JAX package's partitions are
`.msgpack` files, and their reader waits for its own slice (ROADMAP Queue 1
item 5).
"""

from __future__ import annotations

from typing import Optional

from dsin_tpu_torch.coding.codec import BottleneckCodec
from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.models.dsin import DSIN, build_model


def load_model_state(ae_config_path: str, pc_config_path: str,
                     ckpt_dir: Optional[str] = None,
                     need_sinet: bool = False, seed: int = 0,
                     device="cuda") -> DSIN:
    """The DSIN model of the two config files on `device` (the card by
    default; raises without one), its weights from `seed`. siNet is built
    iff `need_sinet`, whatever the config's `AE_only` says; the seeded
    autoencoder, probclass and centers are the same either way."""
    if ckpt_dir:
        raise NotImplementedError(
            f"restoring {ckpt_dir!r}: reading the JAX package's .msgpack "
            f"checkpoints is not ported yet (ROADMAP Queue 1 item 5); "
            f"without a checkpoint the weights come from the seeded init")
    ae_cfg = parse_config_file(ae_config_path).replace(
        AE_only=not need_sinet)
    pc_cfg = parse_config_file(pc_config_path)
    return build_model(ae_cfg, pc_cfg, device=device, seed=seed)


def make_codec(model: DSIN) -> BottleneckCodec:
    """The one BottleneckCodec construction every call site shares."""
    return BottleneckCodec.for_model(model)
