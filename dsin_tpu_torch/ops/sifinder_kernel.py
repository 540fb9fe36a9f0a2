"""Fused masked-Pearson patch search + arg-max on the card (counterpart of the
JAX package's `ops/sifinder_pallas.py`).

The CUDA kernel is `csrc/sifinder_argmax.cu` (its header gives the design and
its bounds): the search on the tensor cores in 3xTF32 (each fp32 operand
split into two TF32 parts, three TF32 products per fp32 product). This module
builds it with `nvcc` at first use (`native_build`), binds it with `ctypes`,
and holds everything around it:

* the query prep: search transform + mean-centered, L2-normalized patches
  laid out in the kernel's (dc, ch, dr) k-order (`prepare_query`);
* the side prep: the transformed side image as (C, H, W) and the Pearson
  denominator in **rsqrt** form (`side_from_transformed`). It is the ONE
  derivation that both the from-scratch search and a cached `SidePrep` use,
  so the two give bit-identical results. No padding: the kernel masks the
  ragged edges itself;
* `pearson_argmax` (the per-image search) and `pearson_argmax_shared` (a
  batch of requests against one cached side image): one kernel, with batch
  stride 0 on the side operands for the shared form;
* `pearson_argmax_reference`, the same function in plain torch, in the same
  multiply order. The wrappers use it for tensors on the CPU, and only
  there: a CUDA tensor launches the kernel or raises;
* `round_tf32` and `split_tf32`, the kernel's operand split in plain torch
  (`cvt.rna.tf32.f32`: round to nearest, ties away from zero).

Each wrapper counts its launches in `launch_counts`.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from dsin_tpu_torch import native_build
from dsin_tpu_torch.ops import color as color_lib
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.ops.patches import assemble_patches, extract_patches

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "sifinder_argmax.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TILES_PER_GROUP = 8     # stage-1 position tiles walked by one block
REFERENCE_ROW_CHUNK = 16   # map rows per matmul in the plain version

# one count per wrapper call that launches the kernel; never incremented by
# the plain version
launch_counts = {"pearson_argmax": 0, "pearson_argmax_shared": 0}


_counts_lock = threading.Lock()   # service workers launch concurrently


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count_launch(name: str) -> None:
    with _counts_lock:
        launch_counts[name] += 1


class KernelLibrary(NamedTuple):
    search: Callable           # sifinder_pearson_argmax
    error_string: Callable
    position_tile: int
    path: str
    build_seconds: float       # 0.0 when the library was already built
    ptxas_log: str             # nvcc -Xptxas -v output of this build


@functools.lru_cache(maxsize=None)
def load_library(source: Path = SOURCE) -> KernelLibrary:
    """Build `source` (by default `csrc/sifinder_argmax.cu`; another version
    of it with the same entry for a comparison) into `build/` (keyed by a
    hash of the source and flags) unless already built, and bind it. Raises
    on failure."""
    so, seconds, log = native_build.build(Path(source), native_build.nvcc(),
                                          NVCC_FLAGS, "sifinder_argmax")
    lib = ctypes.CDLL(str(so))
    search = lib.sifinder_pearson_argmax
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    search.argtypes = [ptr, ll, ptr, ptr, ll, ptr, ptr, ptr, ptr, ptr, ptr,
                       i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
    search.restype = i32
    err_str = lib.sifinder_argmax_error_string
    err_str.argtypes = [i32]
    err_str.restype = ctypes.c_char_p
    lib.sifinder_argmax_position_tile.restype = i32
    return KernelLibrary(search, err_str,
                         int(lib.sifinder_argmax_position_tile()), str(so),
                         seconds, log)


# -- preps -------------------------------------------------------------------

def prepare_query(x_dec: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(N, H, W, 3) decoded images -> (N, P, K) normalized patches in the
    kernel's (dc, ch, dr) k-order, K = pw * C * ph."""
    xn = sifinder_lib.normalized_patches(color_lib.search_transform(
        extract_patches(x_dec, ph, pw)))                # (N, P, ph, pw, C)
    n, p = xn.shape[:2]
    return xn.permute(0, 1, 3, 4, 2).reshape(n, p, -1).contiguous()


def side_from_transformed(r_img: torch.Tensor, ph: int, pw: int):
    """(H, W, C) transformed side image -> (y_t (C, H, W), inv_denom (Hc, Wc))
    with the rsqrt form of the Pearson denominator. The one derivation shared
    by the from-scratch search and the cached `SidePrep`."""
    inv_denom = torch.rsqrt(sifinder_lib.window_variance(r_img, ph, pw)
                            + sifinder_lib.EPS)
    return r_img.permute(2, 0, 1).contiguous(), inv_denom.contiguous()


# -- the search --------------------------------------------------------------

def _check(y_t, pk, inv_denom, gh, gw_t, ph: int, pw: int, batched: bool):
    tensors = {"y_t": y_t, "pk": pk, "inv_denom": inv_denom, "gh": gh,
               "gw_t": gw_t}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: the patch-search kernel "
                            "takes float32 operands only")
        if t.device != y_t.device:
            raise ValueError(f"{name} on {t.device}, y_t on {y_t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if y_t.dim() != (4 if batched else 3) or pk.dim() != 3:
        raise ValueError(f"y_t {tuple(y_t.shape)} / pk {tuple(pk.shape)}: "
                         "wrong rank")
    c, h, w = y_t.shape[-3:]
    b, p, _ = pk.shape
    hc, wc = h - ph + 1, w - pw + 1
    side_b = (b,) if batched else ()
    expect = {"y_t": side_b + (c, h, w), "pk": (b, p, c * ph * pw),
              "inv_denom": side_b + (hc, wc), "gh": (hc, p), "gw_t": (p, wc)}
    for name, shape in expect.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, "
                             f"expected {shape}")


def launch(y_t, pk, inv_denom, gh, gw_t, ph: int, pw: int, batched: bool,
           name: str = "pearson_argmax", lib: KernelLibrary = None):
    """Launch the kernel of `lib` (by default the package's) on checked
    operands; raises on a tensor off the card and on a refused launch. The
    wrappers' launch, without their count (a comparison of two builds times
    them through this)."""
    if y_t.device.type != "cuda":
        raise ValueError(f"the patch-search kernel runs on CUDA tensors, got "
                         f"{y_t.device}")
    lib = lib or load_library()
    c, h, w = y_t.shape[-3:]
    b, p, _ = pk.shape
    hc, wc = h - ph + 1, w - pw + 1
    n_tiles = -(-(hc * wc) // lib.position_tile)
    groups = -(-n_tiles // TILES_PER_GROUP)
    dev = y_t.device
    part_val = torch.empty((b, groups, p), dtype=torch.float32, device=dev)
    part_idx = torch.empty((b, groups, p), dtype=torch.int32, device=dev)
    best_val = torch.empty((b, p), dtype=torch.float32, device=dev)
    best_idx = torch.empty((b, p), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.search(
            y_t.data_ptr(), c * h * w if batched else 0, pk.data_ptr(),
            inv_denom.data_ptr(), hc * wc if batched else 0, gh.data_ptr(),
            gw_t.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
            best_val.data_ptr(), best_idx.data_ptr(), b, c, h, w, ph, pw, p,
            TILES_PER_GROUP, groups, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")
    return best_val, best_idx


def _launch(name: str, y_t, pk, inv_denom, gh, gw_t, ph: int, pw: int,
            batched: bool):
    out = launch(y_t, pk, inv_denom, gh, gw_t, ph, pw, batched, name)
    _count_launch(name)
    return out


def pearson_argmax(y_t: torch.Tensor, pk: torch.Tensor,
                   inv_denom: torch.Tensor, gh: torch.Tensor,
                   gw_t: torch.Tensor, ph: int, pw: int):
    """Streamed masked-Pearson arg-max over every position, per image.

    y_t (B, C, H, W) transformed side images; pk (B, P, K) from
    `prepare_query`; inv_denom (B, Hc, Wc) rsqrt form; gh (Hc, P) and
    gw_t (P, Wc) the separable prior. Returns (best_val (B, P) f32,
    best_idx (B, P) int32 = row * Wc + col)."""
    _check(y_t, pk, inv_denom, gh, gw_t, ph, pw, batched=True)
    if y_t.device.type == "cpu":
        return pearson_argmax_reference(y_t, pk, inv_denom, gh, gw_t, ph, pw)
    return _launch("pearson_argmax", y_t, pk, inv_denom, gh, gw_t, ph, pw,
                   batched=True)


def pearson_argmax_shared(y_t: torch.Tensor, pk: torch.Tensor,
                          inv_denom: torch.Tensor, gh: torch.Tensor,
                          gw_t: torch.Tensor, ph: int, pw: int):
    """`pearson_argmax` for a batch of requests sharing ONE side image:
    y_t (C, H, W) and inv_denom (Hc, Wc) are un-batched (batch stride 0 in
    the kernel). Same kernel and arithmetic: identical side inputs give
    bit-identical outputs to the per-image form."""
    _check(y_t, pk, inv_denom, gh, gw_t, ph, pw, batched=False)
    if y_t.device.type == "cpu":
        b = pk.shape[0]
        return pearson_argmax_reference(
            y_t.expand(b, *y_t.shape), pk,
            inv_denom.expand(b, *inv_denom.shape), gh, gw_t, ph, pw)
    return _launch("pearson_argmax_shared", y_t, pk, inv_denom, gh, gw_t, ph,
                   pw, batched=False)


def pearson_argmax_reference(y_t: torch.Tensor, pk: torch.Tensor,
                             inv_denom: torch.Tensor, gh: torch.Tensor,
                             gw_t: torch.Tensor, ph: int, pw: int):
    """The kernel's function in plain torch: im2col (`unfold`) over chunks
    of `REFERENCE_ROW_CHUNK` map rows, one matmul per chunk, the epilogue in
    the kernel's multiply order ((num * inv_denom) * gh) * gw, and a merge
    that keeps the first maximum (chunks ascend; torch.argmax takes the first
    maximum inside one). Same shapes as `pearson_argmax`."""
    b, c, h, w = y_t.shape
    p = pk.shape[1]
    hc, wc = h - ph + 1, w - pw + 1
    # (dc, ch, dr) -> unfold's (ch, dr, dc) k-order
    pk_u = pk.reshape(b, p, pw, c, ph).permute(0, 1, 3, 4, 2).reshape(b, p, -1)
    best_val = torch.full((b, p), float("-inf"), dtype=torch.float32,
                          device=y_t.device)
    best_idx = torch.zeros((b, p), dtype=torch.int32, device=y_t.device)
    for i in range(b):
        for r0 in range(0, hc, REFERENCE_ROW_CHUNK):
            r1 = min(r0 + REFERENCE_ROW_CHUNK, hc)
            cols = F.unfold(y_t[i:i + 1, :, r0:r1 + ph - 1], (ph, pw))[0]
            num = (pk_u[i] @ cols).reshape(p, r1 - r0, wc)
            score = num * inv_denom[i, r0:r1][None]
            score = score * gh[r0:r1].t()[:, :, None]
            score = score * gw_t[:, None, :]
            flat = score.reshape(p, -1)
            loc = torch.argmax(flat, dim=1)
            val = torch.gather(flat, 1, loc[:, None])[:, 0]
            take = val > best_val[i]            # strict: earlier rows win ties
            best_val[i] = torch.where(take, val, best_val[i])
            best_idx[i] = torch.where(take, (r0 * wc + loc).to(torch.int32),
                                      best_idx[i])
    return best_val, best_idx


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 fraction bits), ties away from
    zero, as `cvt.rna.tf32.f32`: the low 13 bits of the result are 0."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    rounded = ((bits & 0xFFFFFFFF) + 0x1000) & 0xFFFFE000
    return (rounded - ((rounded & 0x80000000) << 1)).to(torch.int32).view(
        torch.float32)


def split_tf32(x: torch.Tensor):
    """float32 -> (hi, lo): hi = `round_tf32(x)` and lo = x - hi, exact in
    float32, so hi + lo == x. The kernel multiplies hi and
    `round_tf32(lo)`."""
    hi = round_tf32(x)
    return hi, x - hi


def scores_at(y_t: torch.Tensor, pk: torch.Tensor, inv_denom: torch.Tensor,
              gh: torch.Tensor, gw_t: torch.Tensor, ph: int, pw: int,
              idx: torch.Tensor) -> torch.Tensor:
    """Plain-torch score of every patch at the flat positions idx (B, P), in
    the kernel's multiply order; batched operand shapes as for
    `pearson_argmax`."""
    b, c, _, w = y_t.shape
    p = pk.shape[1]
    wc = w - pw + 1
    dev = y_t.device
    idx = idx.long()
    rows, cols = torch.div(idx, wc, rounding_mode="floor"), idx % wc
    r = rows[:, :, None, None, None] + torch.arange(ph, device=dev)[:, None]
    cc = cols[:, :, None, None, None] + torch.arange(pw, device=dev)
    win = y_t[torch.arange(b, device=dev)[:, None, None, None, None],
              torch.arange(c, device=dev)[:, None, None], r, cc]
    win = win.permute(0, 1, 4, 2, 3).reshape(b, p, -1)  # (dc, ch, dr) order
    num = torch.sum(pk * win, dim=-1)
    score = num * inv_denom[torch.arange(b, device=dev)[:, None], rows, cols]
    score = score * gh[rows, torch.arange(p, device=dev)]
    return score * gw_t[torch.arange(p, device=dev), cols]


def index_disagreements(operands, ph: int, pw: int, idx: torch.Tensor,
                        ref_val: torch.Tensor, ref_idx: torch.Tensor,
                        atol: float) -> torch.Tensor:
    """(B, P) bool: where `idx` differs from the plain version's `ref_idx`
    AND the plain score at `idx` falls short of the plain best `ref_val` by
    more than `atol`. Zero disagreements means the indices are equal wherever
    the plain version's top-two margin exceeds `atol` (a near-tie may go
    either way under another fp32 summation order). `operands` is
    (y_t, pk, inv_denom, gh, gw_t) in the batched shapes."""
    at = scores_at(*operands, ph, pw, idx)
    return (idx != ref_idx) & (at < ref_val - atol)


# -- y_syn through the kernel ------------------------------------------------

def _assemble(y_img: torch.Tensor, best: torch.Tensor, ph: int, pw: int,
              wc: int) -> torch.Tensor:
    h, w, _ = y_img.shape
    pats = sifinder_lib.gather_patches(
        y_img, torch.div(best, wc, rounding_mode="floor"), best % wc, ph, pw)
    return assemble_patches(pats, h, w)


def fused_synthesize_side_image(x_dec: torch.Tensor, y_img: torch.Tensor,
                                y_dec: torch.Tensor, gh: torch.Tensor,
                                gw: torch.Tensor, ph: int, pw: int,
                                conv_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """Batched y_syn (N, H, W, 3) through `pearson_argmax`; gh (Hc, P) and
    gw (Wc, P) the prior factors (ones for no prior). The correlation's
    operands `pk` and `y_t` are rounded to `conv_dtype` and stay float32
    tensors (the Pallas kernel's `compute_dtype`); the denominator and the
    prior stay unrounded."""
    pk = sifinder_lib.round_operand(prepare_query(x_dec, ph, pw), conv_dtype)
    sides = [side_from_transformed(color_lib.search_transform(yd), ph, pw)
             for yd in y_dec]
    y_t = sifinder_lib.round_operand(torch.stack([s[0] for s in sides]),
                                     conv_dtype)
    inv_denom = torch.stack([s[1] for s in sides])
    wc = y_t.shape[-1] - pw + 1
    _, best = pearson_argmax(y_t, pk, inv_denom, gh.contiguous(),
                             gw.t().contiguous(), ph, pw)
    return torch.stack([_assemble(y_img[i], best[i], ph, pw, wc)
                        for i in range(x_dec.shape[0])])


def fused_synthesize_side_image_prepped(x_dec: torch.Tensor, prep, ph: int,
                                        pw: int) -> torch.Tensor:
    """Batched y_syn (N, H, W, 3) against ONE cached `SidePrep` built with
    `for_kernel=True`: only the query prep runs per request, its patches
    rounded to the dtype the prep's `y_t` was rounded to."""
    if prep.y_t is None:
        raise ValueError("prep lacks the kernel half: "
                         "build_side_prep(..., for_kernel=True)")
    pk = sifinder_lib.round_operand(prepare_query(x_dec, ph, pw),
                                    prep.conv_dtype)
    wc = prep.y_t.shape[-1] - pw + 1
    _, best = pearson_argmax_shared(prep.y_t, pk, prep.inv_denom, prep.gh_k,
                                    prep.gw_t, ph, pw)
    return torch.stack([_assemble(prep.y_img, best[i], ph, pw, wc)
                        for i in range(x_dec.shape[0])])
