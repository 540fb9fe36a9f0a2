"""Time the patch-search kernel (K1/K2) on the card at the main paths'
shapes, for one or more versions of its source, in turns.

    python -m dsin_tpu_torch.tools.k1_bench [--source A.cu --source B.cu]
        [--shapes NAME,...] [--turns 1] [--seed 0] [--out F.json]

Each `--source` (default: the package's `csrc/sifinder_argmax.cu`) is a
version of the kernel with the same `extern "C"` entry; it is built with the
module's flags and run through `ops/sifinder_kernel.launch`. The shapes
(`SHAPES`; all by default):
  * k1_b2_320x1224: K1, batch 2 at 320x1224 with 20x24 patches (P 816,
    K 1440) and the Gaussian prior: the forward's search;
  * k2_b4_320x1224: K2, 4 requests against one side image: a served SI
    batch;
  * k1_b1_320x960: K1, batch 1 at the 320x960 training crop;
  * k1_b1_1024x2048: K1, batch 1 at 1024x2048 with 16x32 patches (P 4096,
    K 1536): the Cityscapes geometry.
The operands are seeded uniform images through the port's own preps. Each
version is held against the plain version (values rtol 1e-4, atol 1e-5;
indices equal wherever the plain top-two margin exceeds 1e-4). Versions run
in turns: A B .. B A, `turns` times over. Beside them, once per shape: the
plain version (im2col and one cuBLAS fp32 matmul per 16 map rows) and the
library call (one `F.conv2d` of the whole score map, then the epilogue and
`torch.argmax`, the epilogue in place above 8 GiB so one map is live; not
where the map exceeds LIBRARY_MAX_BYTES, and an allocator failure is
recorded in place of the time). Times are CUDA events over back-to-back
launches (`k4_bench.warm_ms`). Bounds: fp32 on the CUDA cores (FLOPs / 67
TFLOP/s), 3xTF32 on the tensor cores (3 x FLOPs / 495 TFLOP/s), and the bytes
(inputs read once, outputs written once, at 3.35 TB/s).
Prints one line per (version, shape) and, last, a JSON object; exits 1 when
a version disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from dsin_tpu_torch import native_build
from dsin_tpu_torch.ops import color as color_lib
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.ops import sifinder_kernel as sk
from dsin_tpu_torch.runtime import resolve_device
from dsin_tpu_torch.tools.k4_bench import ptxas_summary, warm_ms

FP32_PEAK = 67e12          # H100 SXM fp32 outside the tensor cores, 700 W
TF32_PEAK = 495e12         # H100 SXM TF32 dense (tensor cores), 700 W
HBM_RATE = 3.35e12         # H100 SXM device memory, bytes/s
VAL_RTOL, VAL_ATOL = 1e-4, 1e-5
MARGIN_ATOL = 1e-4
# the largest library score map tried (1024x2048's is 31.1 GiB; 80 GB card),
# and the size above which its epilogue runs in place
LIBRARY_MAX_BYTES, INPLACE_ABOVE_BYTES = 48 << 30, 8 << 30
# name: (kind, batch, H, W, ph, pw, kernel reps)
SHAPES = {
    "k1_b2_320x1224": ("K1", 2, 320, 1224, 20, 24, 5),
    "k2_b4_320x1224": ("K2", 4, 320, 1224, 20, 24, 5),
    "k1_b1_320x960": ("K1", 1, 320, 960, 20, 24, 10),
    "k1_b1_1024x2048": ("K1", 1, 1024, 2048, 16, 32, 2),
}


def operands(kind: str, batch: int, h: int, w: int, ph: int, pw: int,
             seed: int, dev):
    """Batched (y_t, pk, inv_denom, gh, gw_t) from seeded uniform images
    and the Gaussian prior; K2 shares its first side image."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 255, (batch, h, w, 3)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.uniform(
        0, 255, (1 if kind == "K2" else batch, h, w, 3)).astype(
            np.float32)).to(dev)
    sides = [sk.side_from_transformed(color_lib.search_transform(yi), ph, pw)
             for yi in y]
    y_t = torch.stack([s[0] for s in sides]).expand(batch, -1, -1, -1)
    inv = torch.stack([s[1] for s in sides]).expand(batch, -1, -1)
    gh, gw = sifinder_lib.gaussian_position_mask_factors(h, w, ph, pw)
    return (y_t.contiguous(), sk.prepare_query(x, ph, pw), inv.contiguous(),
            torch.from_numpy(gh).to(dev),
            torch.from_numpy(np.ascontiguousarray(gw.T)).to(dev))


def shared_form(ops):
    """The K2 operands: one side image, batch stride 0."""
    y_t, pk, inv, gh, gw_t = ops
    return y_t[0].contiguous(), pk, inv[0].contiguous(), gh, gw_t


def bounds(ops, shared: bool) -> dict:
    """The least time of one call, in ms, three ways: the fp32 products on
    the CUDA cores, the same products as 3xTF32 on the tensor cores, and the
    bytes (inputs read once, outputs written once)."""
    y_t, pk, inv, gh, gw_t = ops
    b, p, k = pk.shape
    hc, wc = inv.shape[-2:]
    flops = 2.0 * b * p * k * hc * wc
    side = 1 if shared else b
    nbytes = 4 * (side * y_t[0].numel() + pk.numel() + side * hc * wc
                  + gh.numel() + gw_t.numel() + 2 * b * p)
    return dict(flops=flops, fp32_ms=flops / FP32_PEAK * 1e3,
                tf32x3_ms=3 * flops / TF32_PEAK * 1e3,
                bytes_ms=nbytes / HBM_RATE * 1e3)


def library_argmax(ops, ph: int, pw: int, shared: bool):
    """Yardstick: the whole score map through one F.conv2d call, then the
    epilogue (in place above INPLACE_ABOVE_BYTES) and torch.argmax. Not
    used by the port."""
    y_t, pk, inv, gh, gw_t = ops
    b, p, _ = pk.shape
    c = y_t.shape[-3]
    filters = pk.reshape(b * p, pw, c, ph).permute(0, 2, 3, 1)
    if shared:
        num = F.conv2d(y_t[None], filters)[0].reshape(b, p, *inv.shape)
        inv = inv[None]
    else:
        num = F.conv2d(y_t.reshape(1, b * c, *y_t.shape[-2:]), filters,
                       groups=b)[0].reshape(b, p, *inv.shape[-2:])
        inv = inv[:, None]
    if num.numel() * num.element_size() > INPLACE_ABOVE_BYTES:
        # one map live; below this size the out-of-place chain measured
        # faster on the H100 (PERF.md, the kernel table)
        score = num.mul_(inv).mul_(gh.t()[None, :, :, None]).mul_(
            gw_t[None, :, None, :])
    else:
        score = num * inv * gh.t()[None, :, :, None] \
            * gw_t[None, :, None, :]
    return torch.argmax(score.reshape(b, p, -1), dim=2)


def agreement(ops, ph: int, pw: int, got, ref) -> dict:
    """Values within rtol/atol, indices equal beyond the margin."""
    val, idx = got
    rval, ridx = ref
    bad = int(sk.index_disagreements(ops, ph, pw, idx, rval, ridx,
                                     MARGIN_ATOL).sum())
    close = bool(torch.allclose(val, rval, rtol=VAL_RTOL, atol=VAL_ATOL))
    return dict(agrees=close and bad == 0,
                max_abs_err=float((val - rval).abs().max()),
                equal_indices=int((idx == ridx).sum()), indices=idx.numel(),
                disagreements=bad)


def sass_mma(path: str) -> dict:
    """{mnemonic: count} of the matrix instructions in a built library's
    SASS (`cuobjdump -sass`)."""
    tool = Path(native_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for line in sass.splitlines():
        for word in line.split():
            if word.startswith(("HMMA", "HGMMA")):
                out[word] = out.get(word, 0) + 1
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", action="append", type=Path)
    parser.add_argument("--shapes", default=",".join(SHAPES))
    parser.add_argument("--turns", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    sources = args.source or [sk.SOURCE]
    libs = [sk.load_library(s.resolve()) for s in sources]
    builds = {}
    for src, lib in zip(sources, libs):
        builds[str(src)] = dict(ptxas=ptxas_summary(lib.ptxas_log),
                                sass_mma=sass_mma(lib.path))
        print(f"{src}: ptxas {builds[str(src)]['ptxas']}; SASS "
              f"{builds[str(src)]['sass_mma']}", flush=True)
    order = list(range(len(libs)))
    order = (order + order[::-1]) * args.turns
    shapes, runs, bad = {}, [], 0
    for name in args.shapes.split(","):
        kind, batch, h, w, ph, pw, reps = SHAPES[name]
        shared = kind == "K2"
        ops = operands(kind, batch, h, w, ph, pw, args.seed, dev)
        call = shared_form(ops) if shared else ops
        ref = sk.pearson_argmax_reference(*ops, ph, pw)
        plain = warm_ms(lambda: sk.pearson_argmax_reference(*ops, ph, pw),
                        max(1, reps // 2))
        bnd = bounds(call, shared)
        hc, wc = ops[2].shape[-2:]
        map_bytes = 4.0 * batch * ops[1].shape[1] * hc * wc
        library, library_error = None, None
        if map_bytes <= LIBRARY_MAX_BYTES:
            try:
                library = warm_ms(lambda: library_argmax(call, ph, pw, shared),
                                  max(1, reps // 2))
            except torch.cuda.OutOfMemoryError as e:
                library_error = str(e).splitlines()[0]
                torch.cuda.empty_cache()
        else:
            library_error = f"not run (a {map_bytes / 2**30:.1f} GiB map)"
        shapes[name] = dict(kind=kind, batch=batch, crop=[h, w],
                            patch=[ph, pw], P=int(ops[1].shape[1]),
                            K=int(ops[1].shape[2]), map=[int(hc), int(wc)],
                            plain_ms=plain, library_ms=library,
                            library_error=library_error, **bnd)
        print(f"{name}: plain {plain:.3f} ms, library "
              + (f"{library:.3f} ms" if library is not None else
                 library_error)
              + f"; bounds fp32 {bnd['fp32_ms']:.3f} ms, 3xTF32 "
              f"{bnd['tf32x3_ms']:.3f} ms, bytes {bnd['bytes_ms']:.4f} ms",
              flush=True)
        for v in order:
            got = sk.launch(*call, ph, pw, not shared, lib=libs[v])
            torch.cuda.synchronize()
            agree = agreement(ops, ph, pw, got, ref)
            bad += not agree["agrees"]
            ms = warm_ms(lambda: sk.launch(*call, ph, pw, not shared,
                                           lib=libs[v]), reps)
            runs.append(dict(source=str(sources[v]), shape=name, ms=ms,
                             share_fp32=bnd["fp32_ms"] / ms,
                             share_tf32x3=bnd["tf32x3_ms"] / ms, **agree))
            print(f"  {sources[v]}: {ms:.3f} ms, {100 * bnd['fp32_ms'] / ms:.1f}"
                  f"% of the fp32 bound, {100 * bnd['tf32x3_ms'] / ms:.1f}% "
                  f"of the 3xTF32 bound; indices equal "
                  f"{agree['equal_indices']}/{agree['indices']}, max |val - "
                  f"plain| {agree['max_abs_err']:.3g}"
                  + ("" if agree["agrees"] else " DISAGREES"), flush=True)
        del ops, call, ref
        torch.cuda.empty_cache()
    result = dict(card=card, builds=builds, shapes=shapes, runs=runs)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
