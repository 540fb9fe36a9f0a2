"""Precision ladder for the serving path (counterpart of the JAX package's
`coding/precision.py`).

A `PrecisionPolicy` names one rung of the inference precision ladder and casts
a DSIN model (`models/dsin.py`) onto it, in place:

* ``fp32``: the baseline; everything float32 (the cast leaves the model
  as it is).
* ``bf16``: the distortion-side networks (encoder, decoder, siNet) carry
  bfloat16 parameters and run their convs in bfloat16 (the AE config's
  ``compute_dtype``, models/autoencoder.py `ConvBN`).
* ``int8``: distortion-side parameters are symmetrically fake-quantized to
  8-bit levels (per-tensor scale = max|w|/127, round, dequantize) and stored
  and run in bfloat16.

The cast touches parameters only: the batch-norm running statistics stay
float32, as the JAX package's `batch_stats` do. The entropy-critical
partitions (``probclass`` and the quantizer ``centers`` it conditions on)
feed the rANS frequency tables, which encoder and decoder must rebuild bit
for bit; the cast leaves them as the same parameter objects with the same
storage at every rung, and `check_entropy_critical` verifies they are
float32. A partition that is neither is refused.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

#: ladder rungs, cheapest precision last
RUNGS = ("fp32", "bf16", "int8")

#: top-level partitions pinned to float32 at every rung: the entropy path
#: (probclass logits -> PMFs -> rANS tables)
ENTROPY_CRITICAL = frozenset({"probclass", "centers"})

#: distortion-side partitions a rung may cast (siNet is optional)
DISTORTION_SIDE = ("encoder", "decoder", "sinet")


class PrecisionError(ValueError):
    """Typed refusal: unknown rung or a violated fp32 contract."""


def _fake_quant_int8(leaf: np.ndarray) -> torch.Tensor:
    """Symmetric per-tensor int8 fake-quant, dequantized into bfloat16,
    computed as the JAX package computes it: numpy float32, `rint`, clip to
    +-127, `q * scale`, then round-to-nearest-even into bfloat16."""
    arr = np.asarray(leaf, dtype=np.float32)
    amax = float(np.max(np.abs(arr))) if arr.size else 0.0
    if amax == 0.0:
        return torch.from_numpy(arr).to(torch.bfloat16)
    scale = amax / 127.0
    q = np.clip(np.rint(arr / scale), -127, 127)
    return torch.from_numpy(np.ascontiguousarray(q * scale)).to(
        torch.bfloat16)


def partitions(model: nn.Module) -> dict:
    """{name: module or parameter} of the model's top level: its child
    modules and its own parameters (`centers`). An absent siNet is no
    partition."""
    out = {name: child for name, child in model.named_children()}
    out.update(model.named_parameters(recurse=False))
    return out


@dataclass(frozen=True)
class PrecisionPolicy:
    """One rung of the precision ladder."""

    rung: str = "fp32"

    def __post_init__(self):
        if self.rung not in RUNGS:
            raise PrecisionError(
                f"unknown precision rung {self.rung!r}; ladder is {RUNGS}")

    @property
    def compute_dtype(self) -> str:
        """The AE-config ``compute_dtype`` this rung runs its convs in
        (models/autoencoder.py `ConvBN`): int8 weights still multiply in
        bfloat16."""
        return "float32" if self.rung == "fp32" else "bfloat16"

    def cast_leaf(self, leaf: torch.Tensor) -> torch.Tensor:
        if self.rung == "fp32":
            return leaf
        if self.rung == "bf16":
            return leaf.to(torch.bfloat16)
        return _fake_quant_int8(leaf.detach().float().cpu().numpy()).to(
            leaf.device)

    def cast_model(self, model: nn.Module) -> nn.Module:
        """Cast the parameters of the distortion-side partitions in place;
        the entropy-critical partitions keep their parameter objects and
        storage, buffers (batch-norm statistics) stay as they are. Unknown
        partitions are refused rather than guessed at: a new partition must
        be classified here before it can serve on the ladder. Returns the
        model."""
        parts = partitions(model)
        unknown = sorted(set(parts) - ENTROPY_CRITICAL - set(DISTORTION_SIDE))
        if unknown:
            raise PrecisionError(
                f"partition(s) {unknown} are neither entropy-critical "
                f"{sorted(ENTROPY_CRITICAL)} nor distortion-side "
                f"{list(DISTORTION_SIDE)}: classify them in "
                f"coding/precision.py before serving them on the ladder")
        if self.rung == "fp32":
            return model
        with torch.no_grad():
            for name in DISTORTION_SIDE:
                if name in parts:
                    for param in parts[name].parameters():
                        param.data = self.cast_leaf(param.data)
        return model


def check_entropy_critical(model: nn.Module) -> None:
    """Raise `PrecisionError` unless every parameter and buffer of the
    entropy-critical partitions is float32: the load-time tripwire behind the
    cross-rung stream bit-identity."""
    parts = partitions(model)
    for name in sorted(ENTROPY_CRITICAL & set(parts)):
        part = parts[name]
        tensors = ([("", part)] if isinstance(part, nn.Parameter) else
                   list(part.named_parameters()) + list(part.named_buffers()))
        for key, tensor in tensors:
            if tensor.is_floating_point() and tensor.dtype != torch.float32:
                raise PrecisionError(
                    f"entropy-critical partition {name!r} tensor {key!r} is "
                    f"{tensor.dtype}: the probclass -> rANS path is "
                    f"frozen-point-exact fp32 at every ladder rung")
