"""Soft-to-hard scalar quantizer (counterpart of the JAX package's
`models/quantizer.py`).

L learned scalar centers; soft assignment softmax(-|x - c|^2) (sigma 1, the
only value the reference's forward uses), hard assignment argmin |x - c|, and
the straight-through value ``qbar = qsoft + (qhard - qsoft)``. That
expression is kept as it is: it is not bit-equal to ``qhard``, and the
decoder of the from-scratch forward reads ``qbar``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizerOutput(NamedTuple):
    qbar: torch.Tensor     # straight-through value: hard forward, soft backward
    qsoft: torch.Tensor
    qhard: torch.Tensor
    symbols: torch.Tensor  # int32 center indices


def init_centers(num_centers: int, generator: torch.Generator,
                 initial_range) -> torch.Tensor:
    """Uniform init over `initial_range`, drawn from `generator`."""
    lo, hi = (float(v) for v in initial_range)
    return torch.rand(num_centers, generator=generator) * (hi - lo) + lo


def centers_lookup(centers: torch.Tensor,
                   symbols: torch.Tensor) -> torch.Tensor:
    """Map int symbols back to center values: the decoder-side inverse of
    `quantize(...).symbols`."""
    return centers[symbols.long()]


def quantize(x: torch.Tensor, centers: torch.Tensor) -> QuantizerOutput:
    """Quantize `x` (any shape) against `centers` (L,)."""
    if centers.dim() != 1:
        raise ValueError(f"centers must be 1-D, got {tuple(centers.shape)}")
    dist = torch.square(x[..., None] - centers)
    phi_soft = torch.softmax(-dist, dim=-1)
    symbols = torch.argmin(dist, dim=-1)
    qsoft = torch.sum(phi_soft * centers, dim=-1)
    qhard = centers[symbols]
    qbar = qsoft + (qhard - qsoft).detach()
    return QuantizerOutput(qbar=qbar, qsoft=qsoft, qhard=qhard,
                           symbols=symbols.to(torch.int32))
