"""Side-information patch search ("siFinder") (counterpart of the JAX
package's `ops/sifinder.py`).

For every non-overlapping patch of the decoded image x-hat, find the
best-matching position in the decoded side image y-hat, then gather the
matched patch from the original side image y and mosaic the synthetic side
image y_syn. Two modes, chosen by the config key `use_L2andLAB`:
  * Pearson (default): correlation in H1H2H3 color space times a Gaussian
    position prior, arg-max. Each x-patch is mean-centered and L2-normalized
    once, so Pearson is ``conv(y-hat, x-hat normalized) / window_std(y-hat)``;
  * L2/LAB: the squared distance in CIELAB in conv form
    ``|x|^2 - 2<x,y> + |y|^2``, clamped at 0, minus the mean distance times
    the prior, arg-min.

The search splits into a side half that depends on y alone (`build_side_prep`
-> `SidePrep`) and a per-request query half; the from-scratch search builds a
prep and runs the prepped search, so a cached prep gives bit-identical
results.

Three routes, chosen by the config key `sifinder_impl` (`choose_route`):
  * 'torch'  -- conv + materialized (Hc, Wc, P) score map (`search_single`),
    both modes;
  * 'tiled'  -- row chunks of the score map, each reduced into a running
    per-patch best (`search_single_tiled`): memory O(row_chunk * Wc * P),
    Pearson only; `sifinder_row_chunk` sets the chunk (missing, None or 0 =
    32);
  * 'kernel' -- the fused CUDA kernel (ops/sifinder_kernel.py), Pearson with
    the standard Gaussian prior or none; its wrappers run their plain torch
    version for CPU tensors;
  * 'auto'   -- on CUDA tensors 'kernel' for Pearson with the standard prior
    or none, 'tiled' for Pearson with a custom prior, 'torch' for L2; on
    the CPU 'torch'.
The standard prior travels as its factors (`standard_prior`), so the kernel
and tiled routes never build the (Hc, Wc, P) tensor: 1.18 GB at 320x1224
with 20x24 patches, 33.3 GB at 1024x2048 with 16x32 patches.
The config key `sifinder_dtype` ('float32', 'bfloat16' or 'float16'; missing
or None = float32) rounds the Pearson correlation's two operands, the
normalized x-hat patches and the transformed side image, to that dtype; the
products are summed in float32 on every route (`sifinder_conv_dtype`). The
L2 mode does not honour it: its conv-form distance already cancels in
float32.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dsin_tpu_torch.ops import color as color_lib
from dsin_tpu_torch.ops.patches import assemble_patches, extract_patches

IMPLS = ("auto", "torch", "tiled", "kernel")
ROUTES = ("torch", "tiled", "kernel")
EPS = 1e-12          # inside the square roots of the Pearson normalizers
DEFAULT_ROW_CHUNK = 32
CONV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}

# one count per batched search dispatched on each route (a measurement
# record: which route a call took, read by chip_smoke)
route_counts = {route: 0 for route in ROUTES}


_counts_lock = threading.Lock()   # service workers launch concurrently


def reset_route_counts() -> None:
    with _counts_lock:
        for route in route_counts:
            route_counts[route] = 0


def _count_route(route: str) -> None:
    with _counts_lock:
        route_counts[route] += 1


class PrepDtypeMismatch(ValueError):
    """A SidePrep rounded to one `sifinder_dtype` used by a search under
    another."""


class SearchResult(NamedTuple):
    y_syn: torch.Tensor       # (H, W, 3) synthesized side image
    # (Hc, Wc, P) masked scores (Pearson) or distances (L2); None from the
    # tiled search, which never materializes it
    score_map: Optional[torch.Tensor]
    best_flat: torch.Tensor   # (P,) arg-extremum of the flattened map
    row: torch.Tensor         # (P,) match rows
    col: torch.Tensor         # (P,) match cols
    best_score: torch.Tensor  # (P,) the winning score per patch


class SidePrep(NamedTuple):
    """The request-invariant half of the search for one side image. Pearson
    preps carry `inv_window_std`, L2 preps `sum_y2`. `gh`/`gw` are the prior
    factors (None = no prior). The kernel half (`y_t` .. `gw_t`) exists only
    when built with `for_kernel=True` (Pearson only)."""
    y_img: torch.Tensor                    # (H, W, 3) original y: gather source
    r_img: torch.Tensor                    # (H, W, C) search_transform(y-hat)
    inv_window_std: Optional[torch.Tensor]  # (Hc, Wc) Pearson 1/sqrt(var+eps)
    sum_y2: Optional[torch.Tensor]         # (Hc, Wc) L2 window sum of y-hat^2
    gh: Optional[torch.Tensor]             # (Hc, P)
    gw: Optional[torch.Tensor]             # (Wc, P)
    y_t: Optional[torch.Tensor] = None     # (C, H, W)
    inv_denom: Optional[torch.Tensor] = None  # (Hc, Wc) rsqrt form
    gh_k: Optional[torch.Tensor] = None    # (Hc, P), ones without a prior
    gw_t: Optional[torch.Tensor] = None    # (P, Wc), ones without a prior
    conv_dtype: torch.dtype = torch.float32   # sifinder_dtype it serves


def _pearson_only(impl: str, what: str = "use_L2andLAB") -> ValueError:
    return ValueError(f"sifinder_impl={impl!r} is Pearson-only; use 'torch' "
                      f"for {what}")


def use_l2(config) -> bool:
    return bool(getattr(config, "use_L2andLAB", False))


def sifinder_impl(config) -> str:
    """The config's `sifinder_impl` (missing = 'auto'); 'tiled' and 'kernel'
    refuse the L2 mode."""
    impl = getattr(config, "sifinder_impl", "auto")
    if impl not in IMPLS:
        raise ValueError(f"sifinder_impl={impl!r}: expected one of {IMPLS}")
    if use_l2(config) and impl in ("tiled", "kernel"):
        raise _pearson_only(impl)
    return impl


def sifinder_row_chunk(config, default: int = DEFAULT_ROW_CHUNK) -> int:
    """The one reading of the `sifinder_row_chunk` knob (score-map rows per
    chunk of the tiled search): missing, None or 0 -> `default`."""
    return int(getattr(config, "sifinder_row_chunk", default) or default)


def choose_route(impl: str, device_type: str, *, l2: bool = False,
                 prior: str = "none", kernel_half: bool = True,
                 with_scores: bool = False) -> str:
    """The route ('torch', 'tiled' or 'kernel') a search takes, or the
    ValueError of a combination no route serves. `prior` is 'none',
    'standard' (the Gaussian prior, as factors) or 'custom' (any other
    concrete mask); `kernel_half` says whether a prepped search's SidePrep
    carries the kernel's operands (always true from scratch);
    `with_scores` asks for the winning scores, which the kernel does not
    return."""
    if impl not in IMPLS:
        raise ValueError(f"sifinder_impl={impl!r}: expected one of {IMPLS}")
    if with_scores and l2:
        raise ValueError("with_scores is Pearson-only: an L2 prep's "
                         "distances are not a match-quality correlation")
    if impl == "auto":
        if device_type != "cuda" or l2 or with_scores:
            return "torch"
        if prior == "custom":
            return "tiled"
        return "kernel" if kernel_half else "torch"
    if l2 and impl in ("tiled", "kernel"):
        raise _pearson_only(impl, "an L2 prep")
    if impl == "kernel":
        if with_scores:
            raise ValueError("sifinder_impl='kernel' cannot return match "
                             "scores: the kernel folds them on the card; use "
                             "'torch' or 'tiled' when scores are wanted")
        if prior == "custom":
            raise ValueError("sifinder_impl='kernel' takes only the standard "
                             "gaussian_position_mask (or None); use 'torch' "
                             "or 'tiled' for a custom mask")
        if not kernel_half:
            raise ValueError("sifinder_impl='kernel' needs a SidePrep built "
                             "with for_kernel=True")
    return impl


def service_si_scores(config, device_type: str,
                      quality_enabled: bool) -> Tuple[str, bool]:
    """The service's SI-score decision (the JAX service's rule at its
    `service.py:895-905`) -> (route of its prepped searches, whether they
    return the winning scores). Scores are on only where quality telemetry
    is, the search is Pearson and its route is not the kernel: the kernel
    folds the scores on the card and does not return them, so asking for
    them would push every SI batch off K2 onto the plain search. On the
    card under 'auto' the route is K2 with scores off (telemetry notes
    their absence, as the JAX service does on its Pallas path); on the CPU
    it is 'torch' with scores on."""
    l2 = use_l2(config)
    prior = "standard" if bool(getattr(config, "use_gauss_mask",
                                       False)) else "none"
    route = choose_route(sifinder_impl(config), device_type, l2=l2,
                         prior=prior,
                         kernel_half=prep_for_kernel(
                             config, torch.device(device_type)))
    return route, bool(quality_enabled) and not l2 and route != "kernel"


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
    """Whether a SidePrep for `device` carries the kernel's operands: for
    Pearson under 'kernel', and on the card under 'auto'."""
    impl = sifinder_impl(config)
    return not use_l2(config) and (
        impl == "kernel" or (impl == "auto" and device.type == "cuda"))


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
    """A position prior checked once against the standard Gaussian prior:
    `factors` is (gh, gw) when it is that prior, else None. `mask` is the
    (Hc, Wc, P) tensor, or None for the standard prior held only as its
    factors (`standard_prior`). A search given it skips the element-for-
    element check, which costs a pass over the whole mask, and takes the
    route the check would have chosen."""
    mask: Optional[torch.Tensor]
    factors: Optional[tuple]

    def shape(self):
        if self.mask is not None:
            return tuple(self.mask.shape)
        gh, gw = self.factors
        return (gh.shape[0], gw.shape[0], gh.shape[1])


def check_mask(mask, patch_h: int, patch_w: int) -> CheckedMask:
    """Check an (Hc, Wc, P) prior once, for every search at its image size
    (H = Hc + patch_h - 1, W = Wc + patch_w - 1)."""
    mask = torch.as_tensor(mask)
    hc, wc = mask.shape[:2]
    return CheckedMask(mask, standard_mask_factors(
        mask, hc + patch_h - 1, wc + patch_w - 1, patch_h, patch_w))


def standard_prior(img_h: int, img_w: int, patch_h: int,
                   patch_w: int) -> CheckedMask:
    """The standard Gaussian prior of img_h x img_w images as its factors
    only: no (Hc, Wc, P) tensor exists on the card or on the host. The
    torch route forms the product per image; it equals
    `gaussian_position_mask` bit for bit."""
    return CheckedMask(None, gaussian_position_mask_factors(
        img_h, img_w, patch_h, patch_w))


def build_side_prep(y_img: torch.Tensor, y_dec: torch.Tensor, patch_h: int,
                    patch_w: int, *, use_l2: bool = False, mask_factors=None,
                    for_kernel: bool = False,
                    conv_dtype: torch.dtype = torch.float32) -> SidePrep:
    """SidePrep for one side image (tensors HWC). `mask_factors` is (gh, gw)
    from `gaussian_position_mask_factors`, or None for no prior. An L2 prep
    carries `sum_y2` and no kernel half. `for_kernel=True` also builds the
    kernel's operands, with `y_t` rounded to `conv_dtype` (the prep records
    it; a Pearson search under another dtype raises `PrepDtypeMismatch`)."""
    r_img = color_lib.search_transform(y_dec, use_l2)
    gh = gw = None
    if mask_factors is not None:
        gh, gw = (torch.as_tensor(m, dtype=torch.float32, device=y_img.device)
                  for m in mask_factors)
    if use_l2:
        if for_kernel:
            raise ValueError("the patch-search kernel is Pearson-only; "
                             "build_side_prep(for_kernel=True) cannot serve "
                             "use_l2")
        return SidePrep(y_img=y_img, r_img=r_img, inv_window_std=None,
                        sum_y2=window_sums(r_img, patch_h, patch_w)[1],
                        gh=gh, gw=gw)
    inv_std = 1.0 / torch.sqrt(window_variance(r_img, patch_h, patch_w) + EPS)
    prep = SidePrep(y_img=y_img, r_img=r_img, inv_window_std=inv_std,
                    sum_y2=None, gh=gh, gw=gw, conv_dtype=conv_dtype)
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


def find_matches(score_map: torch.Tensor, use_l2: bool = False):
    """Flat arg-extremum per patch (the first maximum, or for L2 the first
    minimum) -> (best_flat, row, col)."""
    hc, wc, p_count = score_map.shape
    flat = score_map.reshape(hc * wc, p_count)
    best = (torch.argmin(flat, dim=0) if use_l2
            else torch.argmax(flat, dim=0)).to(torch.int32)
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


def _result(prep: SidePrep, best: torch.Tensor, best_score: torch.Tensor,
            wc: int, patch_h: int, patch_w: int, h: int, w: int,
            score_map: Optional[torch.Tensor] = None) -> SearchResult:
    rows = torch.div(best, wc, rounding_mode="floor")
    cols = best % wc
    y_patches = gather_patches(prep.y_img, rows, cols, patch_h, patch_w)
    return SearchResult(y_syn=assemble_patches(y_patches, h, w),
                        score_map=score_map, best_flat=best, row=rows,
                        col=cols, best_score=best_score)


def search_single(x_dec: torch.Tensor, y_img: Optional[torch.Tensor],
                  y_dec: Optional[torch.Tensor], mask, patch_h: int,
                  patch_w: int, prep: Optional[SidePrep] = None,
                  conv_dtype: torch.dtype = torch.float32,
                  use_l2: bool = False) -> SearchResult:
    """Full search for one image pair (tensors HWC), the score map
    materialized. `prep` skips the side half; a prep carrying prior factors
    supplies the prior itself (then `mask` must be None). Pearson: the
    scores times the prior, arg-max; `conv_dtype` rounds the correlation's
    operands. L2 (`use_l2`, or an L2 prep): the conv-form distance clamped
    at 0, minus its global mean times the prior, arg-min; `conv_dtype` is
    not honoured."""
    h, w, _ = x_dec.shape
    if prep is None:
        prep = build_side_prep(y_img, y_dec, patch_h, patch_w,
                               use_l2=use_l2, conv_dtype=conv_dtype)
    if use_l2 != (prep.sum_y2 is not None):
        raise ValueError(f"a {'Pearson' if use_l2 else 'L2'} prep for a "
                         f"{'L2' if use_l2 else 'Pearson'} search")
    if prep.gh is not None:
        if mask is not None:
            raise ValueError("pass the prior as prep factors OR as mask")
        mask = prep.gh[:, None, :] * prep.gw[None, :, :]
    q = color_lib.search_transform(extract_patches(x_dec, patch_h, patch_w),
                                   use_l2)
    if use_l2:
        # |x|^2 - 2<x,y> + |y|^2 cancels in float32 at near-matches (terms
        # ~1e9, true distance ~0): clamp to the mathematical lower bound
        xy = _correlate(q, prep.r_img)
        sum_x2 = torch.sum(q * q, dim=(1, 2, 3))
        scores = torch.clamp(sum_x2 - 2.0 * xy + prep.sum_y2[..., None],
                             min=0.0)
    else:
        _check_prep_dtype(prep, conv_dtype)
        num = _correlate(normalized_patches(q), prep.r_img, conv_dtype)
        scores = num * prep.inv_window_std[..., None]
    if mask is not None:
        mask = torch.as_tensor(mask, device=scores.device)
        # L2 (arg-min): an additive discount of up to the mean distance
        # near each patch's own position, which outweighs the cancellation
        # noise at exact-duplicate ties; Pearson (arg-max): a product
        scores = scores - scores.mean() * mask if use_l2 else scores * mask
    best, _, _ = find_matches(scores, use_l2)
    p_count = scores.shape[-1]
    best_score = torch.gather(scores.reshape(-1, p_count), 0,
                              best.long()[None, :])[0]
    return _result(prep, best, best_score, scores.shape[1], patch_h, patch_w,
                   h, w, score_map=scores)


def chunked_score_argmax(xn: torch.Tensor, r_padded: torch.Tensor,
                         inv_std_padded: torch.Tensor, hc: int,
                         row_chunk: int, mask_chunk_fn, patch_h: int,
                         conv_dtype: torch.dtype = torch.float32):
    """Row-chunked Pearson arg-max over a score map of `hc` rows, never
    materialized: the one scan body of the tiled search (and of a
    shard-local search over a column slice).

    xn (P, ph, pw, C) normalized x-hat patches; r_padded (num_chunks *
    row_chunk + patch_h - 1, W, C) the transformed side image, zero rows
    below; inv_std_padded (num_chunks * row_chunk, width) its reciprocal
    Pearson denominator, zero rows below. Chunks of `row_chunk` score rows
    scan in ascending order: one conv against the chunk's row slice, the
    denominator, then `mask_chunk_fn(scores (P, row_chunk, width), r0)`
    (the prior); rows >= hc are forced to -inf, and a strict '>' merge folds
    the chunk's first maximum into the running best, so an earlier chunk
    wins ties: together the lowest-flat-index rule of an arg-max over the
    whole (hc, width) map. Returns (best_val (P,), best_flat (P,) int32, a
    row-major flat index over (hc, width))."""
    p_count = xn.shape[0]
    num_chunks = -(-hc // row_chunk)
    width = inv_std_padded.shape[1]
    if (r_padded.shape[0] != num_chunks * row_chunk + patch_h - 1
            or inv_std_padded.shape[0] != num_chunks * row_chunk):
        raise ValueError(f"r_padded {tuple(r_padded.shape)} / inv_std_padded "
                         f"{tuple(inv_std_padded.shape)} do not pad {hc} rows "
                         f"to chunks of {row_chunk}")
    filters = round_operand(xn, conv_dtype).permute(0, 3, 1, 2)
    image = round_operand(r_padded, conv_dtype).permute(2, 0, 1)[None]
    dev = xn.device
    best_val = torch.full((p_count,), float("-inf"), device=dev)
    best_flat = torch.zeros((p_count,), dtype=torch.int32, device=dev)
    for r0 in range(0, num_chunks * row_chunk, row_chunk):
        num = F.conv2d(image[:, :, r0:r0 + row_chunk + patch_h - 1],
                       filters)[0]                    # (P, row_chunk, width)
        scores = mask_chunk_fn(num * inv_std_padded[r0:r0 + row_chunk], r0)
        if r0 + row_chunk > hc:
            scores[:, hc - r0:] = float("-inf")
        flat = scores.reshape(p_count, row_chunk * width)
        loc = torch.argmax(flat, dim=1)
        val = torch.gather(flat, 1, loc[:, None])[:, 0]
        take = val > best_val                 # strict: earlier chunk wins
        best_val = torch.where(take, val, best_val)
        best_flat = torch.where(take, (r0 * width + loc).to(torch.int32),
                                best_flat)
    return best_val, best_flat


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """`t` with `rows` zero rows appended along dim 0."""
    if rows == 0:
        return t
    return torch.cat([t, t.new_zeros((rows,) + tuple(t.shape[1:]))])


def search_single_tiled(x_dec: torch.Tensor, y_img: Optional[torch.Tensor],
                        y_dec: Optional[torch.Tensor], patch_h: int,
                        patch_w: int, *, mask_factors=None, mask=None,
                        row_chunk: int = DEFAULT_ROW_CHUNK,
                        conv_dtype: torch.dtype = torch.float32,
                        prep: Optional[SidePrep] = None) -> SearchResult:
    """Pearson search that never materializes the (Hc, Wc, P) score map
    (`chunked_score_argmax`): peak memory O(row_chunk * Wc * P). The same
    scores as `search_single`, row by row, and the same indices.

    The prior comes as separable `mask_factors` (gh (Hc, P), gw (Wc, P),
    the standard Gaussian, multiplied factors first exactly as
    `gaussian_position_mask` builds its product) or as a full `mask` that is
    row-sliced per chunk. A from-scratch call builds a SidePrep; passing
    `prep` skips that build, bit-identical by construction. A prep carrying
    `gh`/`gw` supplies the prior itself (`mask_factors`/`mask` must then be
    None). Pearson only: the L2 mode needs the whole map's mean for its
    prior. `score_map` is None and `best_score` the running best."""
    h, w, _ = x_dec.shape
    hc, wc = h - patch_h + 1, w - patch_w + 1
    if prep is None:
        prep = build_side_prep(y_img, y_dec, patch_h, patch_w,
                               conv_dtype=conv_dtype)
    if prep.inv_window_std is None:
        raise ValueError("the tiled search is Pearson-only: an L2 prep")
    _check_prep_dtype(prep, conv_dtype)
    if prep.gh is not None:
        if mask_factors is not None or mask is not None:
            raise ValueError("pass the prior in the prep OR as "
                             "mask_factors/mask")
        mask_factors = (prep.gh, prep.gw)
    q = color_lib.search_transform(extract_patches(x_dec, patch_h, patch_w))
    dev = x_dec.device
    pad = -(-hc // row_chunk) * row_chunk - hc
    r_pad = _pad_rows(prep.r_img, pad + hc + patch_h - 1
                      - prep.r_img.shape[0])
    inv_pad = _pad_rows(prep.inv_window_std, pad)
    if mask_factors is not None:
        gh, gw = (torch.as_tensor(m, dtype=torch.float32, device=dev)
                  for m in mask_factors)
        gh_t = _pad_rows(gh, pad).t().contiguous()     # (P, rows)
        gw_t = gw.t().contiguous()                     # (P, Wc)

        def mask_chunk(scores, r0):
            prior = (gh_t[:, r0:r0 + row_chunk, None] * gw_t[:, None, :])
            return scores * prior
    elif mask is not None:
        mask = torch.as_tensor(mask, device=dev)

        def mask_chunk(scores, r0):
            rows = _pad_rows(mask[r0:r0 + row_chunk],
                             max(0, r0 + row_chunk - hc))
            return scores * rows.permute(2, 0, 1)
    else:
        def mask_chunk(scores, r0):
            return scores
    best_val, best_flat = chunked_score_argmax(
        normalized_patches(q), r_pad, inv_pad, hc, row_chunk, mask_chunk,
        patch_h, conv_dtype)
    return _result(prep, best_flat, best_val, wc, patch_h, patch_w, h, w)


def _prior_kind(mask, factors) -> str:
    if factors is not None:
        return "standard"
    return "none" if mask is None else "custom"


def synthesize_side_image(x_dec: torch.Tensor, y_img: torch.Tensor,
                          y_dec: torch.Tensor, mask, patch_h: int,
                          patch_w: int, config) -> torch.Tensor:
    """Batched y_syn (N, H, W, 3) from batched inputs. `mask` is None, an
    (Hc, Wc, P) prior, or a `CheckedMask` of one (`check_mask`,
    `standard_prior`). A raw mask is checked element for element against
    the standard Gaussian prior where the route depends on it; the kernel
    takes only that prior, so 'kernel' with any other mask raises and 'auto'
    sends it to 'tiled' on the card (`choose_route`)."""
    impl = sifinder_impl(config)
    l2 = use_l2(config)
    conv_dtype = sifinder_conv_dtype(config)
    h, w = x_dec.shape[1], x_dec.shape[2]
    if isinstance(mask, CheckedMask):
        want = (h - patch_h + 1, w - patch_w + 1,
                (h // patch_h) * (w // patch_w))
        if mask.shape() != want:
            raise ValueError(f"the checked mask has shape {mask.shape()}, "
                             f"images {h}x{w} with {patch_h}x{patch_w} "
                             f"patches need {want}")
        mask, factors = mask.mask, mask.factors
    else:
        factors = (None if impl == "torch" else
                   standard_mask_factors(mask, h, w, patch_h, patch_w))
    route = choose_route(impl, x_dec.device.type, l2=l2,
                         prior=_prior_kind(mask, factors))
    _count_route(route)
    if route == "kernel":
        from dsin_tpu_torch.ops import sifinder_kernel
        if factors is None:
            hc, wc = h - patch_h + 1, w - patch_w + 1
            p_count = (h // patch_h) * (w // patch_w)
            factors = (np.ones((hc, p_count), np.float32),
                       np.ones((wc, p_count), np.float32))
        gh, gw = (torch.as_tensor(f, device=x_dec.device) for f in factors)
        return sifinder_kernel.fused_synthesize_side_image(
            x_dec, y_img, y_dec, gh, gw, patch_h, patch_w, conv_dtype)
    if route == "tiled":
        return torch.stack([search_single_tiled(
            x_dec[i], y_img[i], y_dec[i], patch_h, patch_w,
            mask_factors=factors, mask=None if factors is not None else mask,
            row_chunk=sifinder_row_chunk(config),
            conv_dtype=conv_dtype).y_syn for i in range(x_dec.shape[0])])

    def one(i):
        prep = None
        if mask is None and factors is not None:
            # the standard prior as factors: the product per image
            prep = build_side_prep(y_img[i], y_dec[i], patch_h, patch_w,
                                   use_l2=l2, mask_factors=factors,
                                   conv_dtype=conv_dtype)
        return search_single(x_dec[i], y_img[i], y_dec[i], mask, patch_h,
                             patch_w, prep=prep, conv_dtype=conv_dtype,
                             use_l2=l2).y_syn
    return torch.stack([one(i) for i in range(x_dec.shape[0])])


def synthesize_side_image_prepped(x_dec: torch.Tensor, prep: SidePrep,
                                  patch_h: int, patch_w: int, config,
                                  with_scores: bool = False):
    """Batched y_syn (N, H, W, 3) against ONE cached SidePrep: the serving
    path. The prior comes from the prep's factors; an L2 prep (`sum_y2`
    set) runs the L2 search. 'kernel' needs a prep built with
    `for_kernel=True`; 'auto' takes the kernel for CUDA tensors when the
    prep carries it (`choose_route`). A Pearson prep must have been built
    under the config's `sifinder_dtype`.

    `with_scores=True` returns `(y_syn, best_scores (N, P))`: the winning
    masked Pearson score per patch, the values the arg-max already ranked,
    so y_syn is bit-identical with the flag on or off. The 'torch' and
    'tiled' routes only ('auto' takes 'torch'): the kernel does not return
    scores, and an L2 prep's distances are not a correlation; both raise."""
    impl = sifinder_impl(config)
    conv_dtype = sifinder_conv_dtype(config)
    l2 = prep.sum_y2 is not None
    route = choose_route(impl, x_dec.device.type, l2=l2,
                         prior="none" if prep.gh is None else "standard",
                         kernel_half=prep.y_t is not None,
                         with_scores=with_scores)
    _count_route(route)
    if route == "kernel":
        from dsin_tpu_torch.ops import sifinder_kernel
        _check_prep_dtype(prep, conv_dtype)
        return sifinder_kernel.fused_synthesize_side_image_prepped(
            x_dec, prep, patch_h, patch_w)
    if route == "tiled":
        results = [search_single_tiled(
            x_dec[i], None, None, patch_h, patch_w, prep=prep,
            row_chunk=sifinder_row_chunk(config), conv_dtype=conv_dtype)
            for i in range(x_dec.shape[0])]
    else:
        results = [search_single(x_dec[i], None, None, None, patch_h,
                                 patch_w, prep=prep, conv_dtype=conv_dtype,
                                 use_l2=l2)
                   for i in range(x_dec.shape[0])]
    y_syn = torch.stack([r.y_syn for r in results])
    if with_scores:
        return y_syn, torch.stack([r.best_score for r in results])
    return y_syn
