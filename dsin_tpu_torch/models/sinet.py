"""siNet: dilated-convolution fusion network (counterpart of the JAX
package's `models/sinet.py`).

Nine 3x3 convs, 32 channels, dilations 1, 2, 4, ..., 128, 1, leaky ReLU 0.2,
identity-initialized, no normalization; then a 1x1 conv to 3 channels. Input
is the 6-channel concat of normalized (x_dec, y_syn), NCHW.
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


class SiNet(nn.Module):
    """(N, 6, H, W) normalized concat -> (N, 3, H, W) normalized output."""

    def __init__(self):
        super().__init__()
        cin = 6
        for i, rate in enumerate(DILATIONS):
            self.add_module(f"g_conv{i + 1}", nn.Conv2d(
                cin, FEATURES, 3, padding=rate, dilation=rate))
            cin = FEATURES
        self.g_conv_last = nn.Conv2d(FEATURES, 3, 1)

    def dilated_convs(self):
        return [getattr(self, f"g_conv{i + 1}") for i in range(len(DILATIONS))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.dilated_convs():
            x = F.leaky_relu(conv(x), negative_slope=0.2)
        return self.g_conv_last(x)
