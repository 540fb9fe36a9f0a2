"""Color transforms for the side-information patch search (counterpart of
the JAX package's `ops/color.py`).

* `rgb_to_h1h2h3`: the decorrelated channels H1=R+G, H2=R-G, H3=0.5*(R+B) of
  the Pearson search;
* `rgb_to_lab`: the CIELAB conversion of the L2 search (`use_L2andLAB`);
* `normalize_for_search`: the KITTI per-channel search statistics (Pearson)
  or [-1, 1] scaling (LAB).
"""

from __future__ import annotations

import numpy as np
import torch

SEARCH_MEANS = np.array([93.70454143384742, 98.28243432206516,
                         94.84678088809876], dtype=np.float32)
SEARCH_VARS = np.array([73.56493292844912, 75.88547006820752,
                        76.74838442810665], dtype=np.float32)
RGB_TO_XYZ = np.array([[0.412453, 0.212671, 0.019334],
                       [0.357580, 0.715160, 0.119193],
                       [0.180423, 0.072169, 0.950227]], dtype=np.float32)
XYZ_WHITE = np.array([1 / 0.950456, 1.0, 1 / 1.088754], dtype=np.float32)
F_TO_LAB = np.array([[0.0, 500.0, 0.0],
                     [116.0, -500.0, 200.0],
                     [0.0, 0.0, -200.0]], dtype=np.float32)
LAB_OFFSET = np.array([-16.0, 0.0, 0.0], dtype=np.float32)


def rgb_to_h1h2h3(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> (R+G, R-G, 0.5*(R+B))."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([r + g, r - g, 0.5 * (r + b)], dim=-1)


def normalize_for_search(x: torch.Tensor, use_lab: bool = False
                         ) -> torch.Tensor:
    """Pre-search normalization, (..., 3): Pearson mode scales by the KITTI
    statistics, LAB mode to [-1, 1]."""
    if use_lab:
        return 2.0 * (torch.clamp(x, 0.0, 255.0) / 255.0 - 0.5)
    means = torch.as_tensor(SEARCH_MEANS, dtype=x.dtype, device=x.device)
    scales = torch.as_tensor(SEARCH_VARS, dtype=x.dtype, device=x.device)
    return (x - means) / scales


def search_transform(x: torch.Tensor, use_lab: bool = False) -> torch.Tensor:
    """Transform applied to both sides before the correlation. LAB mode feeds
    the raw [0, 255] pixels to `rgb_to_lab`, as the JAX package does (its
    [-1, 1] scaling is not applied there); Pearson mode normalizes, then maps
    to H1H2H3."""
    if use_lab:
        return rgb_to_lab(x)
    return rgb_to_h1h2h3(normalize_for_search(x))


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of non-negative float32 values: torch has no `cbrt`, so the
    power is taken in float64 and rounded once to float32 (the correctly
    rounded cube root but for halfway cases), where XLA's float32 `cbrt`
    may sit an ulp or two off."""
    return torch.pow(x.double(), 1.0 / 3.0).to(x.dtype)


def _mix(x: torch.Tensor, matrix: np.ndarray) -> torch.Tensor:
    """(N, 3) @ (3, 3) as a float32 product on x's device."""
    return x @ torch.as_tensor(matrix, dtype=x.dtype, device=x.device)


def rgb_to_lab(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB -> CIELAB (D65), the JAX package's pipeline step for step:
    gamma expansion, the XYZ matrix, the white point, the cube-root branch
    and the Lab matrix, (..., 3) in and out."""
    px = srgb.reshape(-1, 3)
    linear = px / 12.92
    expanded = ((px + 0.055) / 1.055) ** 2.4
    rgb_lin = torch.where(px <= 0.04045, linear, expanded)
    xyz = _mix(rgb_lin, RGB_TO_XYZ) * torch.as_tensor(
        XYZ_WHITE, dtype=srgb.dtype, device=srgb.device)
    eps = 6 / 29
    f = torch.where(xyz <= eps ** 3, xyz / (3 * eps ** 2) + 4 / 29,
                    _cbrt(torch.clamp(xyz, min=0.0)))
    lab = _mix(f, F_TO_LAB) + torch.as_tensor(
        LAB_OFFSET, dtype=srgb.dtype, device=srgb.device)
    return lab.reshape(srgb.shape)
