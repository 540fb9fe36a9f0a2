"""Multi-Scale SSIM in torch, NHWC (counterpart of the JAX package's
`ops/msssim.py`; its host oracle is `eval/msssim_np.py`).

Wang et al. 2003: 5 levels, weights [0.0448, 0.2856, 0.3001, 0.2363,
0.1333]; per level SSIM and contrast from an 11x11 (sigma 1.5) Gaussian
window, VALID convolution, means over the whole valid map; between levels
a [1/2, 1/2] average with the last row / column repeated for odd extents,
then stride-2 subsampling. The blur is two depthwise 1-D convolutions; the
second moments are taken on per-image-mean-centered inputs (the textbook
E[x^2] - E[x]^2 cancels in float32 on smooth deep levels), as the JAX
package computes them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gauss_kernel_1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def _blur_valid(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """VALID separable blur of NHWC `img` along H then W."""
    n, h, w, c = img.shape
    x = img.permute(0, 3, 1, 2)
    size = kernel.shape[0]
    kh = kernel.reshape(1, 1, size, 1).expand(c, 1, size, 1)
    kw = kernel.reshape(1, 1, 1, size).expand(c, 1, 1, size)
    x = F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)
    return x.permute(0, 2, 3, 1)


def _ssim_and_cs(img1, img2, max_val, filter_size, filter_sigma, k1, k2,
                 batch=None):
    _, h, w, _ = img1.shape
    size = min(filter_size, h, w)
    sigma = size * filter_sigma / filter_size if filter_size else 0.0
    c1_shift = img1.mean(dim=(1, 2, 3), keepdim=True)
    c2_shift = img2.mean(dim=(1, 2, 3), keepdim=True)
    z1, z2 = img1 - c1_shift, img2 - c2_shift
    if filter_size:
        kernel = torch.as_tensor(_gauss_kernel_1d(size, sigma),
                                 device=img1.device)
        mz1, mz2 = _blur_valid(z1, kernel), _blur_valid(z2, kernel)
        sigma11 = _blur_valid(z1 * z1, kernel) - mz1 * mz1
        sigma22 = _blur_valid(z2 * z2, kernel) - mz2 * mz2
        sigma12 = _blur_valid(z1 * z2, kernel) - mz1 * mz2
    else:
        mz1, mz2 = z1, z2
        sigma11 = sigma22 = sigma12 = torch.zeros_like(z1)
    mu1, mu2 = mz1 + c1_shift, mz2 + c2_shift
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma11 + sigma22 + c2
    ssim = ((2.0 * mu1 * mu2 + c1) * v1) / ((mu1 * mu1 + mu2 * mu2 + c1) * v2)
    if batch is not None:
        return batch.means((ssim, v1 / v2))
    return ssim.mean(), (v1 / v2).mean()


def _downsample_2x(img: torch.Tensor) -> torch.Tensor:
    """out[i] = (in[2i] + in[min(2i+1, N-1)]) / 2 along H and W."""
    n, h, w, c = img.shape
    pad_h, pad_w = h % 2, w % 2
    if pad_h or pad_w:
        img = F.pad(img.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                    mode="replicate").permute(0, 2, 3, 1)
        h, w = h + pad_h, w + pad_w
    img = img.reshape(n, h // 2, 2, w, c).mean(dim=2)
    return img.reshape(n, h // 2, w // 2, 2, c).mean(dim=3)


def multiscale_ssim(img1: torch.Tensor, img2: torch.Tensor,
                    max_val: float = 255.0, filter_size: int = 11,
                    filter_sigma: float = 1.5, k1: float = 0.01,
                    k2: float = 0.03, weights=None,
                    batch=None) -> torch.Tensor:
    """MS-SSIM between two NHWC batches -> a scalar tensor; `batch`
    (`parallel/data_parallel.BatchAxis`) takes each level's means over the
    global batch that the ranks of a data axis hold in blocks."""
    if img1.ndim != 4 or img1.shape != img2.shape:
        raise ValueError(f"MS-SSIM takes two NHWC batches of one shape, got "
                         f"{tuple(img1.shape)} and {tuple(img2.shape)}")
    weights = torch.tensor(weights if weights is not None else WEIGHTS,
                           dtype=torch.float32, device=img1.device)
    levels = weights.shape[0]
    im1, im2 = img1.to(torch.float32), img2.to(torch.float32)
    mssim, mcs = [], []
    for _ in range(levels):
        ssim, cs = _ssim_and_cs(im1, im2, max_val, filter_size,
                                filter_sigma, k1, k2, batch)
        mssim.append(ssim)
        mcs.append(cs)
        im1, im2 = _downsample_2x(im1), _downsample_2x(im2)
    # clamp before the fractional powers: a negative mean cs gives NaN
    mcs_v = torch.clamp(torch.stack(mcs), min=0.0)
    mssim_v = torch.clamp(torch.stack(mssim), min=0.0)
    return (torch.prod(mcs_v[:levels - 1] ** weights[:levels - 1])
            * mssim_v[levels - 1] ** weights[levels - 1])
