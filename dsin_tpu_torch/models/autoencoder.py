"""CVPR-style convolutional autoencoder (counterpart of the JAX package's
`models/autoencoder.py`).

Encoder: two stride-2 5x5 convs (n/2, then n) -> B groups of three residual
blocks with a group skip -> one residual block without activation + outer
skip -> stride-2 5x5 conv to the bottleneck (C channels + 1 heatmap channel).
The decoder mirrors it with stride-2 transposed convs. Batch norm (eps 1e-5;
the running statistics at inference, the batch's in training) follows every
conv. Subsampling factor 8. `remat` recomputes each residual block in the
backward pass.

Public functions take and return NHWC tensors; the modules run NCHW.

Padding follows the reference's "SAME" rule exactly, which torch's
`padding=` argument does not express:
  * a stride-2 5x5 conv on an even extent pads (1, 2), not (2, 2);
  * a stride-2 "SAME" transposed conv of the reference does not flip its
    kernel: it is a correlation over the input zero-dilated by 2, padded
    (k-1 - off, ...) with off = 0 for k=3 and 1 for k=5. Here it runs as
    `conv_transpose2d` with a spatially flipped kernel (the bridge flips it,
    `bridge.py`) and an output crop starting at `off`.

Precision: the AE config's `compute_dtype` ('float32' or 'bfloat16') is the
dtype every conv runs in (`ConvBN`). Batch norm follows flax's order and type
promotion: float32 statistics, ``mul = rsqrt(var + eps) * scale``,
``y = (x - mean) * mul + bias`` computed in float32, and the result in
``promote(x, scale, bias)``. So with float32 parameters and a bfloat16
compute dtype (a config such as `ae_cityscapes_stereo`) every BN output, the
residual adds and the bottleneck are float32 and only the convs run in
bfloat16; on the bf16 and int8 ladder rungs (`coding/precision.py`), whose
cast makes the BN scale and bias bfloat16 too, every BN output is bfloat16:
the ReLUs, the residual adds and the encoder's bottleneck run in bfloat16,
the heatmap gate and `z` are float32 (its ramp is float32), and the decoder
casts to float32 only after its last batch norm, before the denormalization.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dsin_tpu_torch.models import quantizer as quantizer_lib

ARCH_PARAM_N = 128

KITTI_MEAN = np.array([93.70454143384742, 98.28243432206516,
                       94.84678088809876], dtype=np.float32)
KITTI_VAR = np.array([5411.79935676, 5758.60456747, 5890.31451232],
                     dtype=np.float32)
# float32, computed as the reference computes it (np.sqrt(VAR + 1e-10))
_KITTI_STD = np.sqrt(KITTI_VAR + 1e-10)


class EncoderOutput(NamedTuple):
    qbar: torch.Tensor                 # quantized bottleneck, (N, Hb, Wb, C)
    qhard: torch.Tensor
    symbols: torch.Tensor              # int32 (N, Hb, Wb, C)
    z: torch.Tensor                    # pre-quantization bottleneck
    heatmap: Optional[torch.Tensor]    # (N, Hb, Wb, C) in [0, 1] or None


_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(config) -> torch.dtype:
    """The torch dtype of the config's `compute_dtype` (default float32)."""
    name = config.get("compute_dtype", "float32")
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={name!r}: expected one of "
                         f"{sorted(_COMPUTE_DTYPES)}")
    return _COMPUTE_DTYPES[name]


def _const(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def normalize_image(x: torch.Tensor, style: str) -> torch.Tensor:
    """NHWC [0, 255] -> the network's input scale."""
    if style == "OFF":
        return x
    if style == "FIXED":
        return (x - _const(KITTI_MEAN, x)) / _const(_KITTI_STD, x)
    raise ValueError(f"invalid normalization style {style!r}")


def denormalize_image(x: torch.Tensor, style: str) -> torch.Tensor:
    if style == "OFF":
        return x
    if style == "FIXED":
        return x * _const(_KITTI_STD, x) + _const(KITTI_MEAN, x)
    raise ValueError(f"invalid normalization style {style!r}")


def heatmap3d(bottleneck: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C+1) -> mask (N, H, W, C) with
    mask[..., c] = clip(sigmoid(b[..., 0]) * C - c, 0, 1). The ramp is
    float32 whatever the bottleneck's dtype, so the mask is float32."""
    c_total = bottleneck.shape[-1] - 1
    heat2d = torch.sigmoid(bottleneck[..., 0]) * c_total
    ramp = torch.arange(c_total, dtype=torch.float32,
                        device=bottleneck.device)
    return torch.clamp(heat2d[..., None] - ramp, 0.0, 1.0)


def _same_pads(size: int, kernel: int, stride: int):
    """(low, high) padding of a "SAME" conv over one extent."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _transpose_crop(kernel: int, stride: int) -> int:
    """Where the "SAME" transposed conv's output starts inside torch's
    unpadded `conv_transpose2d` output: k - 1 - pad_a, with pad_a the low
    padding of the reference's dilated-correlation form."""
    pad_len = kernel + stride - 2
    pad_a = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    return kernel - 1 - pad_a


BN_MOMENTUM = 0.9


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool = False,
               stats: Optional[dict] = None, batch=None) -> torch.Tensor:
    """Batch norm over NCHW `x` in flax's order and promotion: float32
    statistics, mul = rsqrt(var + eps) * scale, y = (x - mean) * mul + bias
    in float32, the result in promote(x, scale, bias).

    Inference (`train=False`) normalizes by the running statistics. Training
    normalizes by the batch's, computed as flax 0.12's `_compute_stats`
    computes them: float32 means of x and x**2 and the fast, biased variance
    max(0, mean(x**2) - mean(x)**2). `stats`, when given, receives
    {bn: (mean, var)} of the batch, detached, the first time each module
    runs (a rematerialized block runs again in the backward pass and must
    not record twice); `apply_batch_stats` folds them into the running
    statistics. Without `stats` the running statistics stay as they are
    (`bn_stats = 'frozen'`).

    `batch` (`parallel/data_parallel.BatchAxis`), when the batch is split
    over the ranks of a data axis, makes both means the global batch's:
    local sums all-reduced, the sum its own backward, as a global-batch
    program differentiates them."""
    shape = (1, -1, 1, 1)
    if train:
        xf = x.float()
        if batch is None:
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = torch.square(xf).mean(dim=(0, 2, 3))
        else:
            mean, mean2 = batch.means((xf, torch.square(xf)), (0, 2, 3))
        var = torch.clamp(mean2 - torch.square(mean), min=0.0)
        if stats is not None and bn not in stats:
            stats[bn] = (mean.detach(), var.detach())
    else:
        mean, var = bn.running_mean.float(), bn.running_var.float()
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x - mean.reshape(shape)) * mul.reshape(shape) \
        + bn.bias.reshape(shape)
    return y.to(torch.promote_types(torch.promote_types(x.dtype,
                                                        bn.weight.dtype),
                                    bn.bias.dtype))


@torch.no_grad()
def apply_batch_stats(stats: dict) -> None:
    """Fold the batch statistics `batch_norm` recorded into each module's
    running statistics, in flax's order: momentum * running + (1 - momentum)
    * batch, with the biased batch variance."""
    for bn, (mean, var) in stats.items():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                              + (1 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                             + (1 - BN_MOMENTUM) * var)


class ConvBN(nn.Module):
    """Conv (or stride-2 transposed conv) in `dtype` + batch norm (+ optional
    relu). The input and the kernel are cast to `dtype`; the conv's output
    stays in it."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 relu: bool = True, transpose: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.relu, self.transpose, self.dtype = relu, transpose, dtype
        conv_cls = nn.ConvTranspose2d if transpose else nn.Conv2d
        self.conv = conv_cls(cin, cout, kernel, stride=stride, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats: Optional[dict] = None, batch=None) -> torch.Tensor:
        h, w = x.shape[-2:]
        x, weight = x.to(self.dtype), self.conv.weight.to(self.dtype)
        if self.transpose:
            off = _transpose_crop(self.kernel, self.stride)
            x = F.conv_transpose2d(x, weight, stride=self.stride)
            x = x[..., off:off + h * self.stride, off:off + w * self.stride]
        else:
            top, bottom = _same_pads(h, self.kernel, self.stride)
            left, right = _same_pads(w, self.kernel, self.stride)
            x = F.conv2d(F.pad(x, (left, right, top, bottom)), weight,
                         stride=self.stride)
        x = batch_norm(x, self.bn, train, stats, batch)
        return F.relu(x) if self.relu else x


class ResBlock(nn.Module):
    """Two 3x3 conv+BN; relu after the first only (unless relu_first=False);
    residual add."""

    def __init__(self, features: int, relu_first: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = ConvBN(features, features, 3, relu=relu_first,
                            dtype=dtype)
        self.conv1 = ConvBN(features, features, 3, relu=False, dtype=dtype)

    def forward(self, x, train: bool = False, stats: Optional[dict] = None,
                batch=None):
        return self.conv1(self.conv0(x, train, stats, batch), train, stats,
                          batch) + x


class ResGroupStack(nn.Module):
    """B groups of three residual blocks, each group with its own skip, then a
    residual block without activation and an outer skip. `remat=True` runs
    each block under `torch.utils.checkpoint` while gradients are recorded:
    its activations are recomputed in the backward pass instead of stored.
    The numbers and the parameter names are the same either way."""

    def __init__(self, features: int, num_groups: int,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.remat = remat
        blocks = [ResBlock(features, dtype=dtype)
                  for _ in range(3 * num_groups)]
        blocks.append(ResBlock(features, relu_first=False, dtype=dtype))
        self.blocks = nn.ModuleList(blocks)

    def _block(self, i: int, x, train: bool, stats: Optional[dict], batch):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self.blocks[i], x, train, stats, batch,
                              use_reentrant=False)
        return self.blocks[i](x, train, stats, batch)

    def forward(self, x, train: bool = False, stats: Optional[dict] = None,
                batch=None):
        outer = x
        for g in range(self.num_groups):
            inner = x
            for i in range(3):
                x = self._block(3 * g + i, x, train, stats, batch)
            x = x + inner
        return self._block(len(self.blocks) - 1, x, train, stats,
                           batch) + outer


class Encoder(nn.Module):
    """Image (N, H, W, 3) in [0, 255] -> bottleneck (N, H/8, W/8, C(+1))."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        n = config.get("arch_param_N", ARCH_PARAM_N)
        dt = compute_dtype(config)
        c_out = config.num_chan_bn + 1 if config.heatmap else config.num_chan_bn
        self.conv0 = ConvBN(3, n // 2, 5, stride=2, dtype=dt)
        self.conv1 = ConvBN(n // 2, n, 5, stride=2, dtype=dt)
        self.res = ResGroupStack(n, config.arch_param_B, dtype=dt,
                                 remat=bool(config.get("remat", False)))
        self.conv2 = ConvBN(n, c_out, 5, stride=2, relu=False, dtype=dt)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats: Optional[dict] = None, batch=None) -> torch.Tensor:
        x = normalize_image(x, self.config.normalization).permute(0, 3, 1, 2)
        for layer in (self.conv0, self.conv1, self.res, self.conv2):
            x = layer(x, train, stats, batch)
        return x.permute(0, 2, 3, 1)


class Decoder(nn.Module):
    """Quantized bottleneck (N, H/8, W/8, C) -> image (N, H, W, 3) in
    [0, 255]."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        n = config.get("arch_param_N", ARCH_PARAM_N)
        dt = compute_dtype(config)
        self.conv0 = ConvBN(config.num_chan_bn, n, 3, stride=2, transpose=True,
                            dtype=dt)
        self.res = ResGroupStack(n, config.arch_param_B, dtype=dt,
                                 remat=bool(config.get("remat", False)))
        self.conv1 = ConvBN(n, n // 2, 5, stride=2, transpose=True, dtype=dt)
        self.conv2 = ConvBN(n // 2, 3, 5, stride=2, transpose=True, relu=False,
                            dtype=dt)

    def forward(self, q: torch.Tensor, train: bool = False,
                stats: Optional[dict] = None, batch=None) -> torch.Tensor:
        x = q.permute(0, 3, 1, 2)
        for layer in (self.conv0, self.res, self.conv1, self.conv2):
            x = layer(x, train, stats, batch)
        x = x.float()
        x = denormalize_image(x.permute(0, 2, 3, 1), self.config.normalization)
        return torch.clamp(x, 0.0, 255.0)


def encode(encoder: Encoder, x: torch.Tensor, centers: torch.Tensor,
           train: bool = False, stats: Optional[dict] = None,
           batch=None) -> EncoderOutput:
    """Encoder + heatmap gating + quantization; `train`, `stats` and
    `batch` as for `batch_norm`."""
    bottleneck = encoder(x, train, stats, batch)
    if encoder.config.heatmap:
        heat = heatmap3d(bottleneck)
        z = heat * bottleneck[..., 1:]
    else:
        heat = None
        z = bottleneck
    qout = quantizer_lib.quantize(z, centers)
    return EncoderOutput(qbar=qout.qbar, qhard=qout.qhard,
                         symbols=qout.symbols, z=z, heatmap=heat)
