"""Non-overlapping patch extraction and reassembly (counterpart of the JAX
package's `ops/patches.py`). With stride == patch size on exactly divisible
extents both are pure reshapes. Leading batch dimensions pass through."""

from __future__ import annotations

import torch


def extract_patches(img: torch.Tensor, patch_h: int,
                    patch_w: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., num_patches, patch_h, patch_w, C), row-major
    grid order."""
    *lead, h, w, c = img.shape
    if h % patch_h or w % patch_w:
        raise ValueError(f"image {h}x{w} not divisible by patch "
                         f"{patch_h}x{patch_w}")
    gh, gw = h // patch_h, w // patch_w
    x = img.reshape(*lead, gh, patch_h, gw, patch_w, c)
    x = x.transpose(-4, -3)                      # (..., gh, gw, ph, pw, c)
    return x.reshape(*lead, gh * gw, patch_h, patch_w, c)


def assemble_patches(patches: torch.Tensor, img_h: int,
                     img_w: int) -> torch.Tensor:
    """(..., num_patches, ph, pw, C) row-major grid ->
    (..., img_h, img_w, C)."""
    *lead, n, ph, pw, c = patches.shape
    gh, gw = img_h // ph, img_w // pw
    if n != gh * gw:
        raise ValueError(f"{n} patches do not tile {img_h}x{img_w}")
    x = patches.reshape(*lead, gh, gw, ph, pw, c)
    x = x.transpose(-4, -3)                      # (..., gh, ph, gw, pw, c)
    return x.reshape(*lead, img_h, img_w, c)
