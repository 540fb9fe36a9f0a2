"""Side-information patch search ("siFinder"), Pearson mode (counterpart of
the JAX package's `ops/sifinder.py`).

For every non-overlapping patch of the decoded image x-hat, find the
best-matching position in the decoded side image y-hat (Pearson correlation
in H1H2H3 color space, times a Gaussian position prior), then gather the
matched patch from the original side image y and mosaic the synthetic side
image y_syn.

Each x-patch is mean-centered and L2-normalized once, so Pearson is
``conv(y-hat, x-hat normalized) / window_std(y-hat)``. The search splits into
a side half that depends on y alone (`build_side_prep` -> `SidePrep`) and a
per-request query half; the from-scratch search builds a prep and runs the
prepped search, so a cached prep gives bit-identical results.

Two implementations, chosen by the config key `sifinder_impl`:
  * 'torch'  -- conv + materialized (Hc, Wc, P) score map (this module);
  * 'kernel' -- the fused CUDA kernel (ops/sifinder_kernel.py); its wrappers
    run their plain torch version for CPU tensors;
  * 'auto'   -- 'kernel' for CUDA tensors when the prior is the standard
    Gaussian or absent, else 'torch'.
The config key `sifinder_dtype` ('float32', 'bfloat16' or 'float16'; missing
or None = float32) rounds the correlation's two operands, the normalized
x-hat patches and the transformed side image, to that dtype; the products are
summed in float32 on every route (`sifinder_conv_dtype`).
The L2/LAB mode and the row-tiled search are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dsin_tpu_torch.ops import color as color_lib
from dsin_tpu_torch.ops.patches import assemble_patches, extract_patches

IMPLS = ("auto", "torch", "kernel")
EPS = 1e-12          # inside the square roots of the Pearson normalizers
CONV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}


class PrepDtypeMismatch(ValueError):
    """A SidePrep rounded to one `sifinder_dtype` used by a search under
    another."""


class SearchResult(NamedTuple):
    y_syn: torch.Tensor       # (H, W, 3) synthesized side image
    score_map: torch.Tensor   # (Hc, Wc, P) masked Pearson scores
    best_flat: torch.Tensor   # (P,) argmax of the flattened map
    row: torch.Tensor         # (P,) match rows
    col: torch.Tensor         # (P,) match cols
    best_score: torch.Tensor  # (P,) the winning score per patch


class SidePrep(NamedTuple):
    """The request-invariant half of the search for one side image. `gh`/`gw`
    are the prior factors (None = no prior). The kernel half (`y_t` ..
    `gw_t`) exists only when built with `for_kernel=True`."""
    y_img: torch.Tensor                    # (H, W, 3) original y: gather source
    r_img: torch.Tensor                    # (H, W, C) search_transform(y-hat)
    inv_window_std: torch.Tensor           # (Hc, Wc) 1/sqrt(var + eps)
    gh: Optional[torch.Tensor]             # (Hc, P)
    gw: Optional[torch.Tensor]             # (Wc, P)
    y_t: Optional[torch.Tensor] = None     # (C, H, W)
    inv_denom: Optional[torch.Tensor] = None  # (Hc, Wc) rsqrt form
    gh_k: Optional[torch.Tensor] = None    # (Hc, P), ones without a prior
    gw_t: Optional[torch.Tensor] = None    # (P, Wc), ones without a prior
    conv_dtype: torch.dtype = torch.float32   # sifinder_dtype it serves


def sifinder_impl(config) -> str:
    impl = getattr(config, "sifinder_impl", "auto")
    if impl not in IMPLS:
        raise ValueError(f"sifinder_impl={impl!r}: expected one of {IMPLS}")
    if bool(getattr(config, "use_L2andLAB", False)):
        raise NotImplementedError("the L2/LAB search mode is not ported; "
                                  "set use_L2andLAB = False")
    return impl


def sifinder_conv_dtype(config) -> torch.dtype:
    """The one reading of the `sifinder_dtype` knob (the JAX package's
    `sifinder_conv_dtype`): missing or None -> float32, else the named
    dtype of `CONV_DTYPES`; anything else raises ValueError."""
    val = getattr(config, "sifinder_dtype", None)
    if val is None:
        return torch.float32
    if str(val) not in CONV_DTYPES:
        raise ValueError(f"sifinder_dtype={val!r}: expected None or one of "
                         f"{tuple(CONV_DTYPES)}")
    return CONV_DTYPES[str(val)]


def round_operand(t: torch.Tensor, conv_dtype: torch.dtype) -> torch.Tensor:
    """`t` rounded to `conv_dtype` and held as float32: a product of two
    such values is exact in float32, so a float32 sum of them is what JAX's
    cast operands with `preferred_element_type=float32` compute."""
    if conv_dtype == torch.float32:
        return t
    return t.to(conv_dtype).to(torch.float32)


def _check_prep_dtype(prep: "SidePrep", conv_dtype: torch.dtype) -> None:
    if prep.conv_dtype != conv_dtype:
        raise PrepDtypeMismatch(
            f"the SidePrep was built for sifinder_dtype {prep.conv_dtype}, "
            f"the search runs {conv_dtype}: open the session again")


def prep_for_kernel(config, device: torch.device) -> bool:
    """Whether a SidePrep for `device` carries the kernel's operands: always
    for 'kernel', for the card under 'auto'."""
    impl = sifinder_impl(config)
    return impl == "kernel" or (impl == "auto" and device.type == "cuda")


def window_variance(r_img: torch.Tensor, win_h: int,
                    win_w: int) -> torch.Tensor:
    """Unnormalized variance of y-hat over every (win_h, win_w, C) window,
    clamped at 0: the Pearson denominator before its square root. The torch
    search takes 1/sqrt of it (+ EPS), the kernel's prep rsqrt, as the XLA
    and Pallas paths of the reference do."""
    sum_y, sum_y2 = window_sums(r_img, win_h, win_w)
    patch_size = win_h * win_w * r_img.shape[-1]
    return torch.clamp(sum_y2 - (sum_y * sum_y) / patch_size, min=0.0)


def normalized_patches(x_patches: torch.Tensor) -> torch.Tensor:
    """Mean-center + L2-normalize each patch over its last three dims
    (ph, pw, C); leading dims pass through."""
    dims = (-3, -2, -1)
    xc = x_patches - x_patches.mean(dim=dims, keepdim=True)
    return xc / torch.sqrt(torch.sum(xc * xc, dim=dims, keepdim=True) + EPS)


def window_sums(img: torch.Tensor, win_h: int, win_w: int):
    """Sums of values and squares over (win_h, win_w, C) windows.
    img (H, W, C) -> two maps (H - win_h + 1, W - win_w + 1)."""
    def pool(z):
        s = F.avg_pool2d(z.permute(2, 0, 1)[None], (win_h, win_w), stride=1,
                         divisor_override=1)
        return s[0].sum(dim=0)
    return pool(img), pool(img * img)


def _gaussian_mask_factors_f64(img_h: int, img_w: int, patch_h: int,
                               patch_w: int):
    """Separable 1-D factors of the 2-D Gaussian position prior, float64,
    cropped to the VALID correlation-map extent with offsets patch//2 - 1."""
    grid_w = img_w // patch_w
    num_patches = (img_h // patch_h) * grid_w
    p = np.arange(num_patches)
    center_h = (p // grid_w + 0.5) * patch_h
    center_w = (p % grid_w + 0.5) * patch_w
    sigma_h = 0.5 * img_h
    sigma_w = 0.5 * img_w
    hh = np.arange(img_h, dtype=np.float64)[:, None]
    ww = np.arange(img_w, dtype=np.float64)[:, None]
    gh = np.exp(-4 * np.log(2) * (hh - center_h[None, :]) ** 2 / sigma_h ** 2)
    gw = np.exp(-4 * np.log(2) * (ww - center_w[None, :]) ** 2 / sigma_w ** 2)
    gh = gh[patch_h // 2 - 1: img_h - patch_h // 2, :]
    gw = gw[patch_w // 2 - 1: img_w - patch_w // 2, :]
    return gh, gw


def gaussian_position_mask_factors(img_h: int, img_w: int, patch_h: int,
                                   patch_w: int):
    """gh (Hc, P), gw (Wc, P) float32 numpy, with
    gh[h, p] * gw[w, p] == gaussian_position_mask(...)[h, w, p] exactly."""
    gh, gw = _gaussian_mask_factors_f64(img_h, img_w, patch_h, patch_w)
    return gh.astype(np.float32), gw.astype(np.float32)


def gaussian_position_mask(img_h: int, img_w: int, patch_h: int,
                           patch_w: int) -> np.ndarray:
    """(Hc, Wc, P) float32 prior: the float32 product of the float32 factors."""
    gh, gw = gaussian_position_mask_factors(img_h, img_w, patch_h, patch_w)
    return gh[:, None, :] * gw[None, :, :]


def standard_mask_factors(mask, img_h: int, img_w: int, patch_h: int,
                          patch_w: int):
    """(gh, gw) if `mask` IS the standard Gaussian prior for these shapes
    (every element compared, in row blocks), else None."""
    if mask is None:
        return None
    gh, gw = gaussian_position_mask_factors(img_h, img_w, patch_h, patch_w)
    mask = torch.as_tensor(mask)
    if tuple(mask.shape) != (gh.shape[0], gw.shape[0], gh.shape[1]):
        return None
    gh_t = torch.as_tensor(gh, device=mask.device)
    gw_t = torch.as_tensor(gw, device=mask.device)
    for r0 in range(0, gh.shape[0], 32):
        product = gh_t[r0:r0 + 32, None, :] * gw_t[None, :, :]
        if not torch.equal(mask[r0:r0 + 32], product):
            return None
    return gh, gw


class CheckedMask(NamedTuple):
    """A position prior checked once against the standard Gaussian prior
    (`check_mask`): `factors` is what `standard_mask_factors` returned for
    `mask` ((gh, gw), or None for any other mask). A search given it skips
    the element-for-element check, which costs a pass over the whole
    (Hc, Wc, P) mask, and takes the route the check would have chosen."""
    mask: torch.Tensor
    factors: Optional[tuple]


def check_mask(mask, patch_h: int, patch_w: int) -> CheckedMask:
    """Check an (Hc, Wc, P) prior once, for every search at its image size
    (H = Hc + patch_h - 1, W = Wc + patch_w - 1)."""
    mask = torch.as_tensor(mask)
    hc, wc = mask.shape[:2]
    return CheckedMask(mask, standard_mask_factors(
        mask, hc + patch_h - 1, wc + patch_w - 1, patch_h, patch_w))


def build_side_prep(y_img: torch.Tensor, y_dec: torch.Tensor, patch_h: int,
                    patch_w: int, *, mask_factors=None,
                    for_kernel: bool = False,
                    conv_dtype: torch.dtype = torch.float32) -> SidePrep:
    """SidePrep for one side image (tensors HWC). `mask_factors` is (gh, gw)
    from `gaussian_position_mask_factors`, or None for no prior.
    `for_kernel=True` also builds the kernel's operands, with `y_t` rounded
    to `conv_dtype` (the prep records it; a search under another dtype
    raises `PrepDtypeMismatch`)."""
    r_img = color_lib.search_transform(y_dec)
    inv_std = 1.0 / torch.sqrt(window_variance(r_img, patch_h, patch_w) + EPS)
    gh = gw = None
    if mask_factors is not None:
        gh, gw = (torch.as_tensor(m, dtype=torch.float32, device=y_img.device)
                  for m in mask_factors)
    prep = SidePrep(y_img=y_img, r_img=r_img, inv_window_std=inv_std,
                    gh=gh, gw=gw, conv_dtype=conv_dtype)
    if for_kernel:
        from dsin_tpu_torch.ops import sifinder_kernel
        y_t, inv_denom = sifinder_kernel.side_from_transformed(
            r_img, patch_h, patch_w)
        hc, wc = inv_denom.shape
        if gh is None:
            p_count = (y_img.shape[0] // patch_h) * (y_img.shape[1] // patch_w)
            gh = torch.ones((hc, p_count), device=y_img.device)
            gw = torch.ones((wc, p_count), device=y_img.device)
        prep = prep._replace(y_t=round_operand(y_t, conv_dtype),
                             inv_denom=inv_denom,
                             gh_k=gh.contiguous(), gw_t=gw.t().contiguous())
    return prep


def _correlate(patches: torch.Tensor, image: torch.Tensor,
               conv_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """VALID correlation of image (H, W, C) with patches (P, ph, pw, C) as
    filters -> (H - ph + 1, W - pw + 1, P); both operands rounded to
    `conv_dtype`, the sum in float32."""
    image, patches = (round_operand(t, conv_dtype) for t in (image, patches))
    out = F.conv2d(image.permute(2, 0, 1)[None], patches.permute(0, 3, 1, 2))
    return out[0].permute(1, 2, 0)


def find_matches(score_map: torch.Tensor):
    """Flat argmax per patch (first maximum) -> (best_flat, row, col)."""
    hc, wc, p_count = score_map.shape
    best = torch.argmax(score_map.reshape(hc * wc, p_count), dim=0)
    best = best.to(torch.int32)
    return best, torch.div(best, wc, rounding_mode="floor"), best % wc


def gather_patches(y_image: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, patch_h: int,
                   patch_w: int) -> torch.Tensor:
    """(patch_h, patch_w) windows of y (H, W, C) at integer (row, col) per
    patch -> (P, patch_h, patch_w, C)."""
    dev = y_image.device
    r = rows.long()[:, None] + torch.arange(patch_h, device=dev)
    c = cols.long()[:, None] + torch.arange(patch_w, device=dev)
    return y_image[r[:, :, None], c[:, None, :]]


def search_single(x_dec: torch.Tensor, y_img: Optional[torch.Tensor],
                  y_dec: Optional[torch.Tensor], mask, patch_h: int,
                  patch_w: int, prep: Optional[SidePrep] = None,
                  conv_dtype: torch.dtype = torch.float32) -> SearchResult:
    """Full search for one image pair (tensors HWC). `prep` skips the side
    half; a prep carrying prior factors supplies the prior itself (then
    `mask` must be None). `conv_dtype` rounds the correlation's operands."""
    h, w, _ = x_dec.shape
    if prep is None:
        prep = build_side_prep(y_img, y_dec, patch_h, patch_w,
                               conv_dtype=conv_dtype)
    _check_prep_dtype(prep, conv_dtype)
    if prep.gh is not None:
        if mask is not None:
            raise ValueError("pass the prior as prep factors OR as mask")
        mask = prep.gh[:, None, :] * prep.gw[None, :, :]
    q = color_lib.search_transform(extract_patches(x_dec, patch_h, patch_w))
    num = _correlate(normalized_patches(q), prep.r_img, conv_dtype)
    scores = num * prep.inv_window_std[..., None]
    if mask is not None:
        scores = scores * torch.as_tensor(mask, device=scores.device)
    best, rows, cols = find_matches(scores)
    p_count = scores.shape[-1]
    best_score = torch.gather(scores.reshape(-1, p_count), 0,
                              best.long()[None, :])[0]
    y_patches = gather_patches(prep.y_img, rows, cols, patch_h, patch_w)
    return SearchResult(y_syn=assemble_patches(y_patches, h, w),
                        score_map=scores, best_flat=best, row=rows, col=cols,
                        best_score=best_score)


def synthesize_side_image(x_dec: torch.Tensor, y_img: torch.Tensor,
                          y_dec: torch.Tensor, mask, patch_h: int,
                          patch_w: int, config) -> torch.Tensor:
    """Batched y_syn (N, H, W, 3) from batched inputs. `mask` is None, an
    (Hc, Wc, P) prior, or a `CheckedMask` of one; the kernel takes only the
    standard Gaussian prior (checked element for element here, or once by
    `check_mask`), so 'kernel' with any other mask raises and 'auto' sends
    it to 'torch'."""
    impl = sifinder_impl(config)
    conv_dtype = sifinder_conv_dtype(config)
    h, w = x_dec.shape[1], x_dec.shape[2]
    if isinstance(mask, CheckedMask):
        want = (h - patch_h + 1, w - patch_w + 1,
                (h // patch_h) * (w // patch_w))
        if tuple(mask.mask.shape) != want:
            raise ValueError(f"the checked mask has shape "
                             f"{tuple(mask.mask.shape)}, images {h}x{w} "
                             f"with {patch_h}x{patch_w} patches need {want}")
        mask, factors = mask.mask, mask.factors
    else:
        factors = (None if impl == "torch" else
                   standard_mask_factors(mask, h, w, patch_h, patch_w))
    if impl == "auto":
        impl = ("kernel" if x_dec.is_cuda and (mask is None or factors)
                else "torch")
    if impl == "kernel":
        from dsin_tpu_torch.ops import sifinder_kernel
        if mask is not None and factors is None:
            raise ValueError("sifinder_impl='kernel' takes only the standard "
                             "gaussian_position_mask (or None); use 'torch' "
                             "for a custom mask")
        if factors is None:
            hc, wc = h - patch_h + 1, w - patch_w + 1
            p_count = (h // patch_h) * (w // patch_w)
            factors = (np.ones((hc, p_count), np.float32),
                       np.ones((wc, p_count), np.float32))
        gh, gw = (torch.as_tensor(f, device=x_dec.device) for f in factors)
        return sifinder_kernel.fused_synthesize_side_image(
            x_dec, y_img, y_dec, gh, gw, patch_h, patch_w, conv_dtype)
    return torch.stack([
        search_single(x_dec[i], y_img[i], y_dec[i], mask, patch_h,
                      patch_w, conv_dtype=conv_dtype).y_syn
        for i in range(x_dec.shape[0])])


def synthesize_side_image_prepped(x_dec: torch.Tensor, prep: SidePrep,
                                  patch_h: int, patch_w: int,
                                  config) -> torch.Tensor:
    """Batched y_syn (N, H, W, 3) against ONE cached SidePrep: the serving
    path. 'kernel' needs a prep built with `for_kernel=True`; 'auto' takes
    the kernel for CUDA tensors when the prep carries it. The prep must
    have been built under the config's `sifinder_dtype`."""
    impl = sifinder_impl(config)
    conv_dtype = sifinder_conv_dtype(config)
    _check_prep_dtype(prep, conv_dtype)
    if impl == "auto":
        impl = "kernel" if x_dec.is_cuda and prep.y_t is not None else "torch"
    if impl == "kernel":
        from dsin_tpu_torch.ops import sifinder_kernel
        return sifinder_kernel.fused_synthesize_side_image_prepped(
            x_dec, prep, patch_h, patch_w)
    return torch.stack([
        search_single(x_dec[i], None, None, None, patch_h, patch_w,
                      prep=prep, conv_dtype=conv_dtype).y_syn
        for i in range(x_dec.shape[0])])
