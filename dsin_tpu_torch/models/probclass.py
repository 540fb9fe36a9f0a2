"""Causal 3-D context model ("probclass") estimating symbol entropy
(counterpart of the JAX package's `models/probclass.py`).

The quantized bottleneck is a 3-D volume over (channel-depth D, H, W) with one
feature channel. A stack of VALID masked 3-D convs (filter DHW = (K//2+1, K,
K)) predicts, for every symbol, logits over the L centers from its causal
context only:

* the first layer's mask zeroes the center tap and everything after it in
  raster order within the last depth slice; the other layers keep the center;
* the mask is multiplied into the weights at use;
* the volume is padded context//2 in front (depth only) and on both sides of
  H and W, with `centers[0]` when `use_centers_for_padding`;
* the residual block crops its skip input `[dd:, hw:-hw, hw:-hw]`;
* the final logits pass through a ReLU, as in the reference;
* bitcost = cross-entropy(logits, symbols) * log2(e), bits per symbol.

Tensors inside are NCDHW: (N, 1, D=C, H, W) for the volume.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def context_size(kernel_size: int) -> int:
    """Receptive-field width of the 4-layer stack: 4*(K-1) + 1."""
    return 4 * (kernel_size - 1) + 1


def filter_shape(kernel_size: int):
    """(D, H, W) of each conv filter."""
    return kernel_size // 2 + 1, kernel_size, kernel_size


def make_mask(kernel_size: int, include_center: bool) -> np.ndarray:
    """Causality mask over the (D, H, W) filter: in the last depth slice, zero
    every row below the center row and, in the center row, everything right of
    the center, plus the center tap itself when include_center=False."""
    d, h, w = filter_shape(kernel_size)
    mask = np.ones((d, h, w), dtype=np.float32)
    ch, cw = kernel_size // 2, kernel_size // 2
    start = cw + 1 if include_center else cw
    mask[-1, ch, start:] = 0.0
    mask[-1, ch + 1:, :] = 0.0
    return mask


def pad_volume(vol: torch.Tensor, kernel_size: int, pad_value) -> torch.Tensor:
    """Pad (N, 1, D, H, W): depth front only, H/W both sides, by context//2.

    The pad value is added through the complement of the interior so that a
    tensor pad value (centers[0]) needs no host round trip."""
    pad = context_size(kernel_size) // 2
    cfg = (pad, pad, pad, pad, pad, 0)          # W, H, D(front only)
    padded = F.pad(vol, cfg)
    interior = F.pad(torch.ones_like(vol), cfg)
    return padded + (1.0 - interior) * pad_value


class MaskedConv3d(nn.Module):
    """VALID 3-D conv with a fixed causality mask multiplied into the weights
    at use. `weight` is OIDHW."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 include_center: bool):
        super().__init__()
        fs = filter_shape(kernel_size)
        self.weight = nn.Parameter(torch.zeros((cout, cin) + fs))
        self.bias = nn.Parameter(torch.zeros(cout))
        mask = torch.from_numpy(make_mask(kernel_size, include_center))
        self.register_buffer("mask", mask, persistent=False)

    def forward(self, x):
        return F.conv3d(x, self.weight * self.mask, self.bias)


class ResShallow(nn.Module):
    """conv0 (first mask) -> one residual block -> conv to L logits."""

    def __init__(self, config, num_centers: int):
        super().__init__()
        self.config = config
        k, ks = config.arch_param__k, config.kernel_size
        self.kernel_size = ks
        self.conv0 = MaskedConv3d(1, k, ks, include_center=False)
        self.conv1 = MaskedConv3d(k, k, ks, include_center=True)
        self.conv2 = MaskedConv3d(k, k, ks, include_center=True)
        self.conv3 = MaskedConv3d(k, num_centers, ks, include_center=True)

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        """(N, 1, D, H, W) padded volume -> (N, L, D, H, W) logits."""
        ks = self.kernel_size
        net = F.relu(self.conv0(vol))
        inp = net
        net = self.conv2(F.relu(self.conv1(net)))
        dd, hw = 2 * (ks // 2), ks - 1
        net = net + inp[:, :, dd:, hw:-hw, hw:-hw]
        return F.relu(self.conv3(net))


def get_network_cls(pc_config):
    return {"res_shallow": ResShallow}[pc_config.arch]


def auto_pad_value(pc_config, centers: torch.Tensor):
    """centers[0] when use_centers_for_padding else 0."""
    return centers[0] if pc_config.use_centers_for_padding else 0.0


def logits_from_q(model: ResShallow, q_nhwc: torch.Tensor,
                  pad_value) -> torch.Tensor:
    """q (N, H, W, C) -> causal logits (N, H, W, C, L)."""
    vol = q_nhwc.permute(0, 3, 1, 2)[:, None]        # (N, 1, D=C, H, W)
    vol = pad_volume(vol, model.kernel_size, pad_value)
    logits = model(vol)                              # (N, L, D, H, W)
    return logits.permute(0, 3, 4, 2, 1)


def bitcost(model: ResShallow, q_nhwc: torch.Tensor,
            symbols_nhwc: torch.Tensor, pad_value) -> torch.Tensor:
    """Bits per symbol, shape (N, H, W, C)."""
    logits = logits_from_q(model, q_nhwc, pad_value)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, symbols_nhwc[..., None].long())[..., 0]
    return nll * np.log2(np.e)


def bitcost_to_bpp(bit_cost: torch.Tensor, input_batch: torch.Tensor):
    """Total bits / total image pixels. bit_cost (N, H, W, C) over bottleneck
    positions; input_batch (N, H, W, 3)."""
    num_pixels = input_batch.numel() // input_batch.shape[-1]
    return torch.sum(bit_cost) / num_pixels
