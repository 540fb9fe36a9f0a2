"""Fused decoder epilogue + search colour transform on the card (counterpart of
the JAX package's `ops/epilogue_pallas.py`, K4).

The decoder's tail ends with a stride-2 5x5 transposed conv to RGB, an
inference batch norm, the KITTI denormalization and a [0, 255] clip; the
patch search then applies the search transform (search normalization ->
H1H2H3) to that image. K4 runs all of it in one pass and writes both the
decoded image and its search-transformed twin.

The CUDA kernel is `csrc/decode_epilogue.cu` (its header gives the design
and its bound); this module builds it with `nvcc` at first use
(`native_build`), binds it with `ctypes`, and holds:

* `EpilogueParams` and `fold_epilogue_params(decoder, normalization)`: the
  host fold of the decoder's `conv2` (its BN x the denormalization into one
  per-channel affine, the search normalization into the H1H2H3 map),
  computed in numpy float32 as the JAX package's fold computes it, so the
  two folds of the same weights are bit-equal;
* `fused_decode_epilogue(x, *epi)`: NHWC (N, H2, W2, Cin) float32 or
  bfloat16 `x` and `wmat` -> two float32 NHWC images (N, 2*H2, 2*W2, 3). A
  CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
  version, and only a CPU tensor does;
* `epilogue_reference`, the plain version: the JAX reference's lhs-dilated
  correlation as `F.conv2d` over the input zero-dilated by 2 and padded
  ((3, 2), (3, 2)), then the affine, clip and 3x3 map. bfloat16 operands
  are widened to float32 first, as the kernel widens them (products of
  bfloat16 values are exact in float32), so both sum the same float32
  products.

The wrapper counts its launches in `launch_counts`. `load_library(source)`
and `launch(lib, ...)` build and run another version of the kernel's source
with the same entry, uncounted, for a comparison on the card
(`tools/k4_bench.py`).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from dsin_tpu_torch import native_build
from dsin_tpu_torch.models import autoencoder as ae_lib
from dsin_tpu_torch.ops import color as color_lib

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "decode_epilogue.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
K = 5                 # the epilogue deconv's kernel size
BN_EPS = 1e-5         # models/autoencoder.py ConvBN
MAX_CIN = 128         # the kernel's shared-memory staging holds Cin <= 128
DTYPES = (torch.float32, torch.bfloat16)

#: H1H2H3 as a matrix on (..., RGB): columns are (R+G, R-G, .5R+.5B)
H1H2H3 = np.array([[1.0, 1.0, 0.5],
                   [1.0, -1.0, 0.0],
                   [0.0, 0.0, 0.5]], dtype=np.float32)

# one count per wrapper call that launches the kernel; never incremented by
# the plain version
launch_counts = {"fused_decode_epilogue": 0}


_counts_lock = threading.Lock()   # service workers launch concurrently


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count_launch(name: str) -> None:
    with _counts_lock:
        launch_counts[name] += 1


class EpilogueParams(NamedTuple):
    """Host-folded float32 operands: wmat (25*Cin, 3), the deconv kernel
    flattened in (kh, kw, cin) row order; img_scale / img_bias (1, 3) = BN
    affine x denormalization; st_mat (3, 3) / st_bias (1, 3) = the search
    normalization folded into the H1H2H3 map."""
    wmat: torch.Tensor
    img_scale: torch.Tensor
    img_bias: torch.Tensor
    st_mat: torch.Tensor
    st_bias: torch.Tensor


def fold_epilogue_params(decoder, normalization: str) -> EpilogueParams:
    """Fold the decoder's final `conv2` (transposed conv + BN), the
    denormalization of `normalization` ('FIXED' or 'OFF') and the search
    transform into the kernel's operands, on the decoder's device. The
    port's `conv2` kernel is spatially flipped for `conv_transpose2d`
    (`bridge.py`); the fold flips it back to the reference's (kh, kw, Cin,
    3) before the reshape."""
    final = decoder.conv2
    w = _np32(final.conv.weight)                            # (Cin, 3, kh, kw)
    if w.shape[1:] != (3, K, K):
        raise ValueError(f"decoder.conv2 kernel {w.shape}: expected "
                         f"(Cin, 3, {K}, {K})")
    w = w.transpose(2, 3, 0, 1)[::-1, ::-1]                 # (kh, kw, Cin, 3)
    bn = final.bn
    inv_std = 1.0 / np.sqrt(_np32(bn.running_var) + BN_EPS)
    bn_scale = _np32(bn.weight) * inv_std
    bn_bias = _np32(bn.bias) - _np32(bn.running_mean) * bn_scale
    if normalization == "FIXED":
        dn_scale = np.sqrt(ae_lib.KITTI_VAR + 1e-10)
        dn_mean = ae_lib.KITTI_MEAN
    elif normalization == "OFF":
        dn_scale = np.ones(3, np.float32)
        dn_mean = np.zeros(3, np.float32)
    else:
        raise ValueError(f"invalid normalization style {normalization!r}")
    img_scale = bn_scale * dn_scale
    img_bias = bn_bias * dn_scale + dn_mean
    inv_sv = 1.0 / color_lib.SEARCH_VARS
    st_mat = inv_sv[:, None] * H1H2H3
    st_bias = -(color_lib.SEARCH_MEANS * inv_sv) @ H1H2H3
    cin = w.shape[2]
    operands = (w.reshape(K * K * cin, 3), img_scale[None, :],
                img_bias[None, :], st_mat, st_bias[None, :])
    dev = final.conv.weight.device
    return EpilogueParams(*(torch.from_numpy(np.ascontiguousarray(
        a, np.float32)).to(dev) for a in operands))


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class KernelLibrary(NamedTuple):
    epilogue: Callable         # decode_epilogue
    error_string: Callable
    path: str
    build_seconds: float       # 0.0 when the library was already built
    ptxas_log: str             # nvcc -Xptxas -v output of this build


@functools.lru_cache(maxsize=None)
def load_library(source: Path = SOURCE) -> KernelLibrary:
    """Build `source` (by default `csrc/decode_epilogue.cu`; another version
    of it with the same entry for a comparison) into `build/` (keyed by a
    hash of the source and flags) unless already built, and bind it. Raises
    on failure."""
    so, seconds, log = native_build.build(Path(source), native_build.nvcc(),
                                          NVCC_FLAGS, "decode_epilogue")
    lib = ctypes.CDLL(str(so))
    fn = lib.decode_epilogue
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    fn.restype = i32
    err_str = lib.decode_epilogue_error_string
    err_str.argtypes = [i32]
    err_str.restype = ctypes.c_char_p
    return KernelLibrary(fn, err_str, str(so), seconds, log)


def _check(x: torch.Tensor, epi: EpilogueParams) -> int:
    """Raise on what the kernel does not take; -> Cin."""
    if x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)}: expected NHWC (N, H2, W2, Cin)")
    cin = x.shape[3]
    expect = {"wmat": (K * K * cin, 3), "img_scale": (1, 3),
              "img_bias": (1, 3), "st_mat": (3, 3), "st_bias": (1, 3)}
    for name, shape in expect.items():
        t = getattr(epi, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "wmat" and t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: the affine and search "
                            "operands are float32")
    if x.dtype not in DTYPES or epi.wmat.dtype != x.dtype:
        raise TypeError(f"x {x.dtype} / wmat {epi.wmat.dtype}: the epilogue "
                        "kernel takes float32 or bfloat16 operands, both of "
                        "one dtype")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 0 < cin <= MAX_CIN:
        raise ValueError(f"Cin {cin}: the kernel takes 1 <= Cin <= {MAX_CIN}")
    return cin


def fused_decode_epilogue(x: torch.Tensor, wmat: torch.Tensor,
                          img_scale: torch.Tensor, img_bias: torch.Tensor,
                          st_mat: torch.Tensor, st_bias: torch.Tensor):
    """x (N, H2, W2, Cin) pre-deconv activation -> (decoded image
    (N, 2*H2, 2*W2, 3) float32 in [0, 255], its search-transformed twin).
    Operands come from `fold_epilogue_params`; cast `x` and `wmat` to the
    rung's compute dtype before calling; accumulation is float32 either
    way."""
    epi = EpilogueParams(wmat, img_scale, img_bias, st_mat, st_bias)
    cin = _check(x, epi)
    if x.device.type == "cpu":
        return epilogue_reference(x, *epi)
    if x.device.type != "cuda":
        raise ValueError(f"the epilogue kernel runs on CUDA tensors, got "
                         f"{x.device}")
    img, srch = launch(load_library(), x, *epi)
    _count_launch("fused_decode_epilogue")
    return img, srch


def launch(lib: KernelLibrary, x: torch.Tensor, wmat: torch.Tensor,
           img_scale: torch.Tensor, img_bias: torch.Tensor,
           st_mat: torch.Tensor, st_bias: torch.Tensor):
    """Launch `lib`'s kernel on checked CUDA operands; raises on a refused
    launch. The wrapper's launch, without its count (a comparison of two
    builds times them through this)."""
    n, h2, w2, cin = x.shape
    img = torch.empty((n, 2 * h2, 2 * w2, 3), dtype=torch.float32,
                      device=x.device)
    srch = torch.empty_like(img)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.epilogue(x.data_ptr(), wmat.data_ptr(), img_scale.data_ptr(),
                           img_bias.data_ptr(), st_mat.data_ptr(),
                           st_bias.data_ptr(), img.data_ptr(),
                           srch.data_ptr(), n, h2, w2, cin,
                           int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_decode_epilogue launch failed: CUDA error "
                           f"{err} ({lib.error_string(err).decode()})")
    return img, srch


def epilogue_reference(x: torch.Tensor, wmat: torch.Tensor,
                       img_scale: torch.Tensor, img_bias: torch.Tensor,
                       st_mat: torch.Tensor, st_bias: torch.Tensor):
    """The kernel's function in plain torch, float32 throughout: the
    lhs-dilated correlation (no kernel flip) over x zero-dilated by 2 and
    padded ((3, 2), (3, 2)), the folded affine, the clip, the 3x3 map."""
    n, h2, w2, cin = x.shape
    xf = x.float().permute(0, 3, 1, 2)
    dil = xf.new_zeros((n, cin, 2 * h2 - 1, 2 * w2 - 1))
    dil[:, :, ::2, ::2] = xf
    w = wmat.float().reshape(K, K, cin, 3).permute(3, 2, 0, 1)
    conv = F.conv2d(F.pad(dil, (3, 2, 3, 2)), w).permute(0, 2, 3, 1)
    img = torch.clamp(conv * img_scale[0] + img_bias[0], 0.0, 255.0)
    srch = (img.reshape(-1, 3) @ st_mat + st_bias[0]).reshape(img.shape)
    return img, srch
