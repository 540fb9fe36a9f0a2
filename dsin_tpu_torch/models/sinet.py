"""siNet: dilated-convolution fusion network (counterpart of the JAX
package's `models/sinet.py`).

Nine 3x3 convs, 32 channels, dilations 1, 2, 4, ..., 128, 1, leaky ReLU 0.2,
identity-initialized, no normalization; then a 1x1 conv to 3 channels. Input
is the 6-channel concat of normalized (x_dec, y_syn), NCHW.

`dtype` is the compute dtype: the input, kernels and biases are cast to it,
each conv adds its bias in it, the leaky ReLUs run in it, and the output is
returned in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

DILATIONS = (1, 2, 4, 8, 16, 32, 64, 128, 1)
FEATURES = 32


def identity_kernel_(weight: torch.Tensor) -> torch.Tensor:
    """Center-tap identity over matching in/out channels (OIHW weight)."""
    cout, cin, kh, kw = weight.shape
    with torch.no_grad():
        weight.zero_()
        for i in range(min(cin, cout)):
            weight[i, i, kh // 2, kw // 2] = 1.0
    return weight


class _LeakyReLU(torch.autograd.Function):
    """`F.leaky_relu`'s values with `jax.nn.leaky_relu`'s derivative, which
    is 1 at 0 where torch's is the slope. At 0 it matters: the identity
    init leaves 26 of the 32 channels exactly 0, and through nine layers
    the slope would shrink their gradient by 0.2**9. The forward stays one
    kernel."""

    @staticmethod
    def forward(ctx, x, negative_slope):
        ctx.save_for_backward(x)
        ctx.negative_slope = negative_slope
        return F.leaky_relu(x, negative_slope)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, grad, grad * ctx.negative_slope), None


class SiNet(nn.Module):
    """(N, 6, H, W) normalized concat -> (N, 3, H, W) normalized float32
    output."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 6
        for i, rate in enumerate(DILATIONS):
            self.add_module(f"g_conv{i + 1}", nn.Conv2d(
                cin, FEATURES, 3, padding=rate, dilation=rate))
            cin = FEATURES
        self.g_conv_last = nn.Conv2d(FEATURES, 3, 1)

    def dilated_convs(self):
        return [getattr(self, f"g_conv{i + 1}") for i in range(len(DILATIONS))]

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        out = F.conv2d(x, conv.weight.to(self.dtype), padding=conv.padding,
                       dilation=conv.dilation)
        return out + conv.bias.to(self.dtype).reshape(1, -1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for conv in self.dilated_convs():
            x = _LeakyReLU.apply(self._conv(conv, x), 0.2)
        return self._conv(self.g_conv_last, x).float()
