"""Color transforms for the side-information patch search, Pearson mode
(counterpart of the JAX package's `ops/color.py`).

`rgb_to_h1h2h3` maps RGB to the decorrelated channels H1=R+G, H2=R-G,
H3=0.5*(R+B); `normalize_for_search` scales by the KITTI per-channel search
statistics. The L2/LAB search mode is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

SEARCH_MEANS = np.array([93.70454143384742, 98.28243432206516,
                         94.84678088809876], dtype=np.float32)
SEARCH_VARS = np.array([73.56493292844912, 75.88547006820752,
                        76.74838442810665], dtype=np.float32)


def rgb_to_h1h2h3(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> (R+G, R-G, 0.5*(R+B))."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([r + g, r - g, 0.5 * (r + b)], dim=-1)


def normalize_for_search(x: torch.Tensor) -> torch.Tensor:
    """Pearson-mode pre-search normalization, (..., 3)."""
    means = torch.as_tensor(SEARCH_MEANS, dtype=x.dtype, device=x.device)
    scales = torch.as_tensor(SEARCH_VARS, dtype=x.dtype, device=x.device)
    return (x - means) / scales


def search_transform(x: torch.Tensor) -> torch.Tensor:
    """Transform applied to both sides before the Pearson correlation."""
    return rgb_to_h1h2h3(normalize_for_search(x))
