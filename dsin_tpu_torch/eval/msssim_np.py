"""Numpy MS-SSIM: the host-side eval oracle (a copy of the JAX package's
`eval/msssim_np.py`; only this docstring differs).

The reference keeps a second, independent MS-SSIM implementation in
numpy/scipy for test-time reporting (reference ms_ssim_np_imgcomp.py,
used by utils.py:94-99) so graph and eval scores can cross-check each
other. This module plays the same role for the torch implementation
(`ops/msssim.py`): written directly from the Wang et al. 2003 spec,
sharing no code with the device path.

Spec: 5 scales, weights [0.0448, 0.2856, 0.3001, 0.2363, 0.1333]; per scale
SSIM/contrast means from an 11x11 sigma-1.5 Gaussian window (VALID
convolution); between scales a 2x2 box blur with reflect boundary then
stride-2 subsampling.
"""

from __future__ import annotations

import numpy as np

_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])


def _gauss_2d(size: int, sigma: float) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    g = np.exp(-(xx * xx + yy * yy) / (2.0 * sigma * sigma))
    return g / g.sum()


def _ssim_cs(a: np.ndarray, b: np.ndarray, max_val: float,
             filter_size: int, filter_sigma: float,
             k1: float, k2: float):
    """Mean SSIM and mean contrast-structure term for one scale.

    a, b: (N, H, W, C) float64.
    """
    from scipy.signal import fftconvolve

    _, h, w, _ = a.shape
    size = min(filter_size, h, w)
    # shrink sigma proportionally when the image is smaller than the window
    sigma = size * filter_sigma / filter_size if filter_size else 0.0
    win = _gauss_2d(size, sigma).reshape(1, size, size, 1)

    mu_a = fftconvolve(a, win, mode="valid")
    mu_b = fftconvolve(b, win, mode="valid")
    sigma_aa = fftconvolve(a * a, win, mode="valid") - mu_a * mu_a
    sigma_bb = fftconvolve(b * b, win, mode="valid") - mu_b * mu_b
    sigma_ab = fftconvolve(a * b, win, mode="valid") - mu_a * mu_b

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    v1 = 2.0 * sigma_ab + c2
    v2 = sigma_aa + sigma_bb + c2
    ssim = np.mean(((2.0 * mu_a * mu_b + c1) * v1) /
                   ((mu_a * mu_a + mu_b * mu_b + c1) * v2))
    cs = np.mean(v1 / v2)
    return ssim, cs


def _downsample_2x(x: np.ndarray) -> np.ndarray:
    """2x2 box blur (reflect boundary) + stride-2 subsample."""
    from scipy.ndimage import convolve

    kernel = np.ones((1, 2, 2, 1)) / 4.0
    return convolve(x, kernel, mode="reflect")[:, ::2, ::2, :]


def multiscale_ssim_np(img1: np.ndarray, img2: np.ndarray, *,
                       max_val: float = 255.0, filter_size: int = 11,
                       filter_sigma: float = 1.5, k1: float = 0.01,
                       k2: float = 0.03, levels: int = 5) -> float:
    """MS-SSIM of two image batches.

    img1, img2: (N, H, W, C) or (H, W, C) arrays in [0, max_val].
    Returns a python float in [0, 1] (1 = identical).
    """
    a = np.asarray(img1, dtype=np.float64)
    b = np.asarray(img2, dtype=np.float64)
    if a.ndim == 3:
        a, b = a[None], b[None]
    assert a.shape == b.shape and a.ndim == 4, (a.shape, b.shape)

    mssim = np.empty(levels)
    mcs = np.empty(levels)
    for lvl in range(levels):
        mssim[lvl], mcs[lvl] = _ssim_cs(a, b, max_val, filter_size,
                                        filter_sigma, k1, k2)
        if lvl < levels - 1:
            a, b = _downsample_2x(a), _downsample_2x(b)

    # clamp to >= 0 before the fractional powers (negative mean cs from an
    # anti-correlated scale would give NaN); mirrors the device path
    mcs = np.maximum(mcs, 0.0)
    mssim = np.maximum(mssim, 0.0)
    w = _WEIGHTS[:levels]
    return float(np.prod(mcs[:-1] ** w[:-1]) * (mssim[-1] ** w[-1]))
