"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases; any failure raises, prints no result and exits non-zero:
  1. card check: needs torch.cuda; prints the card's name and power limit;
  2. build: builds csrc/sifinder_argmax.cu, csrc/probclass_front.cu and
     csrc/decode_epilogue.cu with nvcc and csrc/range_coder.cpp with g++,
     all four at once, and prints the build times and ptxas's register /
     spill lines;
  3. kernel vs plain at 320x1224 with 20x24 patches: pearson_argmax at batch 2
     (random inputs with the Gaussian prior, and planted patches without it)
     and pearson_argmax_shared at batch 4, each against its plain torch
     version; prints times (CUDA events), the bound and a yardstick library
     call (materialized F.conv2d score map + argmax, never called by the
     port);
  4. the slice at the full width of ae_kitti_stereo + pc_default with seeded
     weights: one session, 4 requests (encode -> decode_si) and one
     from-scratch forward at batch 2, each checked for shape, finite values
     and range, and for launches of its kernel, then timed stage by stage
     (CUDA events), and the decoder with cudnn.deterministic on and off;
     then the tiny configuration through the kernel on the
     card against the plain search on the CPU;
  5. the codec at full width: probclass_front_logits (K3) against its plain
     version at B = 1, 5, 64, 128, 256 and the largest front (248) on blocks
     drawn from the centers with the full-width pc_default weights (within
     1e-5, rows bit-identical across B and under a permutation, and
     unchanged by NaN in every input no logit needs), timed at the largest
     front beside its bound (the work the logit needs) and a cuDNN
     yardstick; then the symbols of 2 images from DeviceServer.encode coded
     in mode 3 (K3) and mode 2 (numpy engine), each decoded exactly, with
     one K3 launch per front; K3 timed at each bucket of a pass beside its
     bound, and its device time per pass;
     decode_si on the decoded symbols bit-equal to decode_si on the
     originals; compress_array -> decompress_array with and without a side
     image;
  6. the precision ladder: fused_decode_epilogue (K4) against its plain
     version at (2, 160, 612, 64), the full-width decoder's own activation
     before its last deconv, folded from its conv2, with float32 and bfloat16
     operands (rtol 1e-5, atol 1e-3 in pixel units for both: bfloat16
     operands are widened to float32, their products are exact there, so both
     sum the same float32 products in another order), rows bit-identical
     across the batch, the float32 image equal to the decoder's own output
     within the same bound; timed beside its bound and the library chain
     (F.conv_transpose2d + crop, affine, clip, 3x3 map); then the serve-bench
     precision leg at 320x1224, batch 2, fp32, bf16 and int8, which must pass
     gate_precision (every stage timed, no build in the timed window, mode-2
     and mode-3 streams byte-identical across the rungs and exact round
     trips) and launch K2, K3 and K4; at the default seed, every rung's
     streams must keep the pinned sha256 prefixes (STREAM_PINS).
Kernel times are CUDA events around back-to-back runs that the host
enqueued while the device slept, so they are device time.
Then one line with the card, one JSON line with the kernels, and last the
result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from dsin_tpu_torch.coding import cli as cli_lib
from dsin_tpu_torch.coding import codec as codec_lib
from dsin_tpu_torch.coding import probclass_kernel as pk
from dsin_tpu_torch.coding import rans
from dsin_tpu_torch.coding.loader import make_codec
from dsin_tpu_torch.entry import entry, full_configs
from dsin_tpu_torch.models import probclass as pc_lib
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.models.quantizer import centers_lookup
from dsin_tpu_torch.ops import color as color_lib
from dsin_tpu_torch.ops import epilogue as ek
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.ops import sifinder_kernel as sk
from dsin_tpu_torch.runtime import config_path, resolve_device
from dsin_tpu_torch.serve.device import DeviceServer
from dsin_tpu_torch.tools import serve_bench as leg_lib

H, W, PH, PW = 320, 1224, 20, 24
FP32_PEAK = 67e12          # H100 SXM fp32 outside the tensor cores, 700 W
BF16_PEAK = 989e12         # H100 SXM bf16 dense (tensor cores), 700 W
HBM_RATE = 3.35e12         # H100 SXM device memory, bytes/s
VAL_RTOL, VAL_ATOL = 1e-4, 1e-5   # fp32 sums in another order
MARGIN_ATOL = 1e-4         # indices equal where the top-two margin exceeds it
K3_RTOL, K3_ATOL = 1e-5, 1e-5     # as tests/test_probclass_pallas.py:49
K3_BATCHES = (1, 5, 64, 128, 256)   # and the largest front of the volume
K4_RTOL, K4_ATOL = 1e-5, 1e-3     # as tests/test_epilogue_pallas.py:32
LEG_REPS = 5
# sha256 prefixes of the precision leg's streams at the default seed, every
# rung: what the dense probclass front kernel gave; the pruned one must give
# the same logits bit for bit, hence the same streams
STREAM_PINS = {"wavefront_np": "54aab8cb7a425f84",
               "wavefront_pl": "cff25dce13d128d5"}
SOURCES = {
    "pearson_argmax": "dsin_tpu_torch/csrc/sifinder_argmax.cu",
    "pearson_argmax_shared": "dsin_tpu_torch/csrc/sifinder_argmax.cu",
    "probclass_front_logits": "dsin_tpu_torch/csrc/probclass_front.cu",
    "fused_decode_epilogue": "dsin_tpu_torch/csrc/decode_epilogue.cu",
}
REPLACES = {
    "pearson_argmax": "dsin_tpu/ops/sifinder_pallas.py:146",
    "pearson_argmax_shared": "dsin_tpu/ops/sifinder_pallas.py:340",
    "probclass_front_logits": "dsin_tpu/coding/probclass_pallas.py:115",
    "fused_decode_epilogue": "dsin_tpu/ops/epilogue_pallas.py:167",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up. The
    device first sleeps about 10 ms, so the host enqueues the runs ahead of
    it: a short kernel is timed back to back on the device, not at the
    host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def stage_ms(steps) -> str:
    """Device-timeline ms of each (name, fn) step, run in order after one
    warm-up pass, with CUDA events recorded between the steps."""
    with torch.inference_mode():
        for _, fn in steps:
            fn()
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(steps) + 1)]
        events[0].record()
        for i, (_, fn) in enumerate(steps):
            fn()
            events[i + 1].record()
        torch.cuda.synchronize()
    return ", ".join(f"{name} {events[i].elapsed_time(events[i + 1]):.2f}"
                     for i, (name, _) in enumerate(steps))


def smooth_images(rng, n: int, extra_w: int = 0) -> np.ndarray:
    """Seeded smooth RGB images in [0, 255] (bilinear-upsampled noise)."""
    base = rng.uniform(0, 255, (n, 3, H // 8, (W + extra_w) // 8))
    up = F.interpolate(torch.from_numpy(base).float(), size=(H, W + extra_w),
                       mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous().numpy()


def operands(x: np.ndarray, y: np.ndarray, prior: bool, dev):
    """Kernel operands (y_t, pk, inv_denom, gh, gw_t) from NHWC images,
    through the port's own preps."""
    pk = sk.prepare_query(torch.from_numpy(x).to(dev), PH, PW)
    sides = [sk.side_from_transformed(color_lib.search_transform(
        torch.from_numpy(yi).to(dev)), PH, PW) for yi in y]
    if prior:
        gh, gw = sifinder_lib.gaussian_position_mask_factors(H, W, PH, PW)
    else:
        p = (H // PH) * (W // PW)
        gh = np.ones((H - PH + 1, p), np.float32)
        gw = np.ones((W - PW + 1, p), np.float32)
    return (torch.stack([s[0] for s in sides]),
            pk, torch.stack([s[1] for s in sides]),
            torch.from_numpy(gh).to(dev),
            torch.from_numpy(np.ascontiguousarray(gw.T)).to(dev))


def check_agreement(name, ops, got, ref, planted=None):
    val, idx = got
    rval, ridx = ref
    torch.testing.assert_close(val, rval, rtol=VAL_RTOL, atol=VAL_ATOL)
    bad = int(sk.index_disagreements(ops, PH, PW, idx, rval, ridx,
                                     MARGIN_ATOL).sum())
    equal = int((idx == ridx).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} index disagreements beyond the "
                             f"{MARGIN_ATOL} margin")
    if planted is not None:
        for b, p, flat in planted:
            if int(idx[b, p]) != flat or int(ridx[b, p]) != flat:
                raise AssertionError(
                    f"{name}: planted patch {p} of image {b} at {flat}, "
                    f"kernel {int(idx[b, p])}, plain {int(ridx[b, p])}")
    err = float((val - rval).abs().max())
    log(f"  {name}: indices equal {equal}/{idx.numel()} (rest are near-ties "
        f"within {MARGIN_ATOL}), max |val - plain| {err:.3g}"
        + (f", {len(planted)} planted exact" if planted else ""))
    return err


def bound(ops, shared: bool):
    """(bound_ms, bound_by) for one call: operations over the fp32 rate vs
    bytes (inputs read once, outputs written once) over the memory rate."""
    y_t, pk, inv, gh, gw_t = ops
    b, p, k = pk.shape
    hc, wc = inv.shape[-2:]
    flops = 2.0 * b * p * k * hc * wc
    side = 1 if shared else b
    nbytes = 4 * (side * y_t[0].numel() + pk.numel() + side * hc * wc
                  + gh.numel() + gw_t.numel() + 2 * b * p)
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def library_argmax(ops, shared: bool):
    """Yardstick: the whole score map through one F.conv2d call, then the
    epilogue and torch.argmax. Not used by the port."""
    y_t, pk, inv, gh, gw_t = ops
    b, p, _ = pk.shape
    c = y_t.shape[-3]
    filters = pk.reshape(b * p, PW, c, PH).permute(0, 2, 3, 1)
    if shared:
        num = F.conv2d(y_t[None], filters)[0].reshape(b, p, *inv.shape)
        inv = inv[None]
    else:
        num = F.conv2d(y_t.reshape(1, b * c, *y_t.shape[-2:]), filters,
                       groups=b)[0].reshape(b, p, *inv.shape[-2:])
        inv = inv[:, None]
    score = num * inv * gh.t()[None, :, :, None] * gw_t[None, :, None, :]
    return torch.argmax(score.reshape(b, p, -1), dim=2)


def kernel_phase(seed: int, dev):
    rng = np.random.default_rng(seed)
    rows = {}

    # K1 at batch 2: random images with the prior
    x = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    ops = operands(x, y, True, dev)
    got = sk.pearson_argmax(*ops, PH, PW)
    ref = sk.pearson_argmax_reference(*ops, PH, PW)
    err = check_agreement("pearson_argmax random+prior b=2", ops, got, ref)

    # K1 planted: exact copies of 40 x patches per image, no prior
    xp = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    yp = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    hc, wc, gw_n = H - PH + 1, W - PW + 1, W // PW
    planted = []
    for b in range(2):
        for j, p in enumerate(rng.choice((H // PH) * gw_n, 40, replace=False)):
            r0, c0 = (j // 8) * (PH + 8) + 3, (j % 8) * (PW + 120) + 5
            pr, pc = (p // gw_n) * PH, (p % gw_n) * PW
            yp[b, r0:r0 + PH, c0:c0 + PW] = xp[b, pr:pr + PH, pc:pc + PW]
            planted.append((b, int(p), r0 * wc + c0))
    ops_p = operands(xp, yp, False, dev)
    err = max(err, check_agreement(
        "pearson_argmax planted b=2", ops_p, sk.pearson_argmax(*ops_p, PH, PW),
        sk.pearson_argmax_reference(*ops_p, PH, PW), planted))

    reps = 5
    ms = cuda_ms(lambda: sk.pearson_argmax(*ops, PH, PW), reps)
    plain_ms = cuda_ms(lambda: sk.pearson_argmax_reference(*ops, PH, PW), 2)
    lib_ms = cuda_ms(lambda: library_argmax(ops, False), 2)
    b_ms, b_by = bound(ops, False)
    rows["pearson_argmax"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  library_ms=lib_ms)

    # K2 at batch 4: one shared side image, smooth stereo-like pair
    imgs = smooth_images(rng, 1, extra_w=64)
    y1 = imgs[:, :, 16:16 + W]
    x4 = np.clip(np.repeat(imgs[:, :, :W], 4, 0)
                 + rng.normal(0, 4, (4, H, W, 3)), 0, 255).astype(np.float32)
    ops4 = operands(x4, np.repeat(y1, 4, 0), True, dev)
    shared = (ops4[0][0].contiguous(), ops4[1], ops4[2][0].contiguous(),
              ops4[3], ops4[4])
    got = sk.pearson_argmax_shared(*shared, PH, PW)
    ref = sk.pearson_argmax_reference(*ops4, PH, PW)
    err4 = check_agreement("pearson_argmax_shared stereo b=4", ops4, got, ref)
    ms4 = cuda_ms(lambda: sk.pearson_argmax_shared(*shared, PH, PW), reps)
    plain4 = cuda_ms(lambda: sk.pearson_argmax_reference(*ops4, PH, PW), 2)
    lib4 = cuda_ms(lambda: library_argmax(shared, True), 2)
    b4, b4_by = bound(shared, True)
    rows["pearson_argmax_shared"] = dict(max_abs_err=err4, ms=ms4,
                                         plain_ms=plain4, bound_ms=b4,
                                         bound_by=b4_by, library_ms=lib4)
    for name, r in rows.items():
        log(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
            f"ms, library {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f}"
            f" ms ({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of "
            f"bound")
    return rows


def check_image(name, img, shape, clipped: bool):
    if tuple(img.shape) != shape:
        raise AssertionError(f"{name}: shape {tuple(img.shape)} != {shape}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{name}: non-finite values")
    if clipped and not (float(img.min()) >= 0.0 and float(img.max()) <= 255.0):
        raise AssertionError(f"{name}: values outside [0, 255]")


def slice_phase(seed: int, dev):
    rng = np.random.default_rng(seed + 1)
    ae, pc = full_configs()
    server = DeviceServer(ae, pc, device=dev, seed=seed)
    imgs = smooth_images(rng, 4, extra_w=64)
    x = np.clip(imgs[:, :, :W] + rng.normal(0, 4, (4, H, W, 3)),
                0, 255).astype(np.float32)
    y = imgs[0, :, 16:16 + W].copy()

    def serve():
        t0 = time.perf_counter()
        prep = server.open_session(y)
        torch.cuda.synchronize()
        log(f"  open_session {1e3 * (time.perf_counter() - t0):.2f} ms")
        t0 = time.perf_counter()
        symbols, bpp = server.encode(x)
        out = server.decode_si(symbols, prep)
        torch.cuda.synchronize()
        return symbols, bpp, out, time.perf_counter() - t0

    serve()                                   # warm-up: cuDNN plans, build
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    symbols, bpp, out, secs = serve()
    launches = dict(sk.launch_counts)
    if launches["pearson_argmax_shared"] < 1:
        raise AssertionError(f"decode_si did not launch the kernel: "
                             f"{launches}")
    check_image("decode_si", out, (4, H, W, 3), clipped=True)
    if tuple(symbols.shape) != (4, H // 8, W // 8, ae.num_chan_bn):
        raise AssertionError(f"symbols shape {tuple(symbols.shape)}")
    if not bool(torch.isfinite(bpp).all()):
        raise AssertionError("bpp estimate not finite")
    log(f"  serve: 4 requests (encode -> decode_si) {1e3 * secs / 4:.2f} ms "
        f"per request, bpp estimate {bpp.mean().item():.4f}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}")
    model, st = server.model, {}
    xt = torch.from_numpy(x).to(dev)
    prep = server.open_session(y)
    log("  serve stages, batch of 4, device ms: " + stage_ms([
        ("encoder+quantizer",
         lambda: st.update(sym=model.encode(xt).symbols)),
        ("probclass bitcost", lambda: model.bitcost(
            centers_lookup(model.centers, st["sym"]), st["sym"])),
        ("decoder", lambda: st.update(x_dec=model.decode(
            centers_lookup(model.centers, st["sym"])))),
        ("search", lambda: st.update(
            y_syn=sifinder_lib.synthesize_side_image_prepped(
                st["x_dec"], prep, PH, PW, ae))),
        ("siNet", lambda: model.apply_sinet(st["x_dec"], st["y_syn"])),
    ]))
    q = centers_lookup(model.centers, st["sym"])
    det = {True: [], False: []}
    with torch.inference_mode():
        for flag in (True, False, False, True):
            torch.backends.cudnn.deterministic = flag
            det[flag].append(cuda_ms(lambda: model.decode(q), 5))
    torch.backends.cudnn.deterministic = True
    log(f"  decoder, batch of 4, device ms with cudnn.deterministic on "
        f"{det[True][0]:.2f}, {det[True][1]:.2f}; off {det[False][0]:.2f}, "
        f"{det[False][1]:.2f}")

    forward, (xe, ye) = entry(device=dev, full_width=True, batch=2, seed=seed)
    forward(xe, ye)                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    x_si, bpp_e = forward(xe, ye)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    entry_launches = dict(sk.launch_counts)
    if entry_launches["pearson_argmax"] < 1:
        raise AssertionError(f"entry did not launch the kernel: "
                             f"{entry_launches}")
    check_image("entry x_with_si", x_si, (2, H, W, 3), clipped=False)
    if not np.isfinite(float(bpp_e)):
        raise AssertionError("entry bpp not finite")
    log(f"  entry: batch 2 forward {1e3 * secs:.2f} ms, bpp "
        f"{float(bpp_e):.4f}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{entry_launches}")
    mask = torch.as_tensor(sifinder_lib.gaussian_position_mask(H, W, PH, PW),
                           device=dev)     # the same weights: same seed
    log("  entry stages, batch 2, device ms: " + stage_ms([
        ("encode x+y", lambda: st.update(ex=model.encode(xe),
                                         ey=model.encode(ye))),
        ("decode x+y", lambda: st.update(x_dec=model.decode(st["ex"].qbar),
                                         y_dec=model.decode(st["ey"].qbar))),
        ("search", lambda: st.update(y_syn=sifinder_lib.synthesize_side_image(
            st["x_dec"], ye, st["y_dec"], mask, PH, PW, ae))),
        ("siNet", lambda: model.apply_sinet(st["x_dec"], st["y_syn"])),
        ("probclass bitcost", lambda: model.bitcost(st["ex"].qbar,
                                                    st["ex"].symbols)),
    ]))
    del mask

    # small input: kernel route on the card vs the plain route on the CPU
    fwd_gpu, (xs, ys) = entry(device=dev, seed=seed)
    fwd_cpu, _ = entry(device="cpu", seed=seed)
    out_gpu, bpp_gpu = fwd_gpu(xs, ys)
    out_cpu, bpp_cpu = fwd_cpu(xs.cpu(), ys.cpu())
    diff = float((out_gpu.cpu() - out_cpu).abs().max())
    if diff > 0.05 or abs(float(bpp_gpu) - float(bpp_cpu)) > 1e-4 * abs(
            float(bpp_cpu)):
        raise AssertionError(f"tiny forward: card vs CPU max diff {diff}, "
                             f"bpp {float(bpp_gpu)} vs {float(bpp_cpu)}")
    log(f"  tiny forward: card (kernel) vs CPU (plain) max |diff| {diff:.3g}"
        f" of 255, bpp {float(bpp_gpu):.6f} vs {float(bpp_cpu):.6f}")
    return {"pearson_argmax": entry_launches["pearson_argmax"],
            "pearson_argmax_shared": launches["pearson_argmax_shared"]}


def build_phase():
    """Build the four native libraries at once (one compiler each); print
    their build times and ptxas's register / spill lines."""
    with ThreadPoolExecutor(4) as pool:
        futs = {name: pool.submit(fn) for name, fn in (
            ("sifinder_argmax.cu", sk.load_library),
            ("probclass_front.cu", pk.load_library),
            ("decode_epilogue.cu", ek.load_library),
            ("range_coder.cpp", rans.load_library))}
        libs = {name: f.result() for name, f in futs.items()}
    for name, lib in libs.items():
        log(f"  {name}: {lib.build_seconds:.1f} s -> {lib.path}")
        for ln in getattr(lib, "ptxas_log", "").splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"    ptxas: {ln.strip()}")


def k3_bound(batch: int, params):
    """(bound_ms, bound_by) of one K3 call on `batch` blocks: the
    multiply-adds the logit rows need over the fp32 rate (each needed output
    of each layer over the taps its causality mask keeps and its inputs,
    `pk.needed_fmas`: 611,424 a block at C = 24, L = 6) vs the blocks, the
    compacted weights with their tables and the logits over the memory
    rate."""
    c, l_out = params.layout["channels"], params.layout["logits"]
    flops = 2.0 * batch * pk.needed_fmas(c, l_out)
    nbytes = 4 * (batch * int(np.prod(pk.CONTEXT)) + batch * l_out
                  + params.buffer.numel())
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3_phase(model, rng, dev, top: int):
    """K3 against its plain version on blocks drawn from the centers with
    the model's probclass weights; rows bit-identical across B; NaN in every
    input no logit needs changes no logit. Timed at `top`, the largest front
    of the path's volume and its largest bucket."""
    weights = [(torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev))
               for w, b in pc_lib.front_weight_matrices(model.probclass)]
    params = pk.prepare_front(weights)
    centers = model.centers.detach().cpu().numpy()
    batches = sorted(set(K3_BATCHES) | {top})
    n = max(batches)
    blocks = torch.from_numpy(rng.choice(centers, size=(n,) + pk.CONTEXT)
                              .astype(np.float32)).to(dev)
    full = pk.probclass_front_logits(blocks, params)
    err = 0.0
    for b in batches:
        got = pk.probclass_front_logits(blocks[:b].contiguous(), params)
        ref = pk.probclass_front_logits_reference(blocks[:b], weights)
        torch.testing.assert_close(got, ref, rtol=K3_RTOL, atol=K3_ATOL)
        if not torch.equal(got, full[:b]):
            raise AssertionError(f"K3 rows at B={b} differ from the same "
                                 f"rows at B={n}")
        err = max(err, float((got - ref).abs().max()))
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    if not torch.equal(pk.probclass_front_logits(
            blocks[perm.to(dev)].contiguous(), params), full[perm.to(dev)]):
        raise AssertionError("K3 rows depend on their batchmates' order")
    keep = torch.zeros(pk.CONTEXT, dtype=torch.bool)
    for p in pk.needed_positions(pk.KERNEL_SIZE)[0]:
        keep[p] = True
    drop = ~keep.to(dev)
    nan = pk.probclass_front_logits(blocks.masked_fill(drop, float("nan")),
                                    params)
    if not (torch.equal(nan, pk.probclass_front_logits(
            blocks.masked_fill(drop, 0.0), params)) and torch.equal(nan, full)):
        raise AssertionError("K3 logits change with NaN in the "
                             f"{int(drop.sum())} inputs no logit needs")

    timed_blocks = blocks[:top].contiguous()

    def yard():    # the yardstick: cuDNN conv3d through ResShallow
        with torch.inference_mode():
            return model.probclass(timed_blocks[:, None]).reshape(top, -1)

    torch.testing.assert_close(yard(), full[:top], rtol=1e-4, atol=1e-4)
    ms = cuda_ms(lambda: pk.probclass_front_logits(timed_blocks, params), 50)
    plain_ms = cuda_ms(
        lambda: pk.probclass_front_logits_reference(timed_blocks, weights), 10)
    lib_ms = cuda_ms(yard, 10)
    b_ms, b_by = k3_bound(top, params)
    log(f"  K3 vs plain at B={tuple(batches)}: max |kernel - plain| "
        f"{err:.3g} (rtol {K3_RTOL}, atol {K3_ATOL}); rows bit-identical "
        f"across B and under a permutation; NaN in the {int(drop.sum())} "
        f"unneeded inputs of each block changes no logit bit")
    log(f"  K3 at B={top}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (cuDNN conv3d ResShallow) {lib_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of bound")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def codec_path(server, codec, x, y, seed: int):
    """The codec path at full width; returns the K3 launches per pass."""
    symbols, bpp_est = server.encode(x)
    sym_np = symbols.cpu().numpy()
    vols = [np.ascontiguousarray(np.transpose(s, (2, 0, 1))) for s in sym_np]
    n_fronts = len(codec._wavefronts(*vols[0].shape))
    h, w = x.shape[1:3]
    decoded = {}
    pass_ms = []         # host-clock ms of each mode-3 encode / decode pass
    for i, vol in enumerate(vols):
        for mode in ("wavefront_pl", "wavefront_np"):
            k0 = pk.launch_counts["probclass_front_logits"]
            stream, enc_ms = timed(lambda: codec.encode(vol, mode=mode))
            k1 = pk.launch_counts["probclass_front_logits"]
            back, dec_ms = timed(lambda: codec.decode(stream))
            k2 = pk.launch_counts["probclass_front_logits"]
            per_pass = (k1 - k0, k2 - k1)
            want = (n_fronts, n_fronts) if mode == "wavefront_pl" else (0, 0)
            if per_pass != want:
                raise AssertionError(f"{mode}: K3 launches per pass "
                                     f"{per_pass}, expected {want}")
            if stream[5] != codec_lib._MODES[mode]:
                raise AssertionError(f"{mode}: header mode byte {stream[5]}")
            if not np.array_equal(back, vol):
                raise AssertionError(f"{mode}: volume {i} did not round-trip "
                                     f"({int((back != vol).sum())} symbols "
                                     f"differ)")
            gap = codec.coding_gap(vol, stream)
            if gap["gap_bits"] < -32:
                # the payload may undercut the bound by at most the 32-bit
                # coder state it opens with, whose start value is free
                raise AssertionError(f"{mode}: coding gap {gap} below the "
                                     f"-32-bit flush allowance")
            decoded.setdefault(mode, []).append(back)
            if mode == "wavefront_pl":
                pass_ms += [enc_ms, dec_ms]
            log(f"  volume {i} {vol.shape} {mode}: encode {enc_ms:.1f} ms, "
                f"decode {dec_ms:.1f} ms, {len(stream)} bytes = "
                f"{len(stream) * 8 / (h * w):.4f} bpp (probclass estimate "
                f"{float(bpp_est[i]):.4f}), coding gap "
                f"{gap['gap_pct']:.3f}%, K3 launches per pass {per_pass}")

    prep = server.open_session(y)
    for mode, backs in decoded.items():
        got = server.decode_si(np.stack([v.transpose(1, 2, 0)
                                         for v in backs]), prep)
        want = server.decode_si(sym_np, prep)
        if not torch.equal(got, want):
            raise AssertionError(f"decode_si on {mode}-decoded symbols is "
                                 f"not bit-equal to decode_si on the "
                                 f"originals")
    log("  decode_si on the decoded symbols (both modes) bit-equal to "
        "decode_si on the originals")

    x0 = x[0]
    blob, c_ms = timed(lambda: cli_lib.compress_array(x0, seed=seed))
    rec, d_ms = timed(lambda: cli_lib.decompress_array(blob))
    payload = cli_lib.parse_dsim(blob)[4]
    sym1 = codec.decode(payload)
    want_sym = server.encode(x0[None])[0][0].cpu().numpy().transpose(2, 0, 1)
    if not np.array_equal(sym1, want_sym):
        raise AssertionError("compress_array's symbols differ from "
                             "DeviceServer.encode's")
    with torch.inference_mode():
        x_dec = server.model.decode(centers_lookup(
            server.model.centers,
            torch.as_tensor(sym1.transpose(1, 2, 0)[None],
                            device=server.device)))
    want_rec = np.clip(x_dec[0].cpu().numpy(), 0, 255).astype(np.uint8)
    if not np.array_equal(rec, want_rec):
        raise AssertionError("decompress_array differs from the decoder on "
                             "the stream's symbols")
    rec_si, s_ms = timed(lambda: cli_lib.decompress_array(blob, side=y))
    want_si = server.decode_si(sym1.transpose(1, 2, 0)[None], prep)
    want_si = np.clip(want_si[0].cpu().numpy(), 0, 255).astype(np.uint8)
    if not np.array_equal(rec_si, want_si):
        raise AssertionError("decompress_array with side differs from "
                             "decode_si on the stream's symbols")
    log(f"  compress_array {c_ms:.0f} ms ({len(blob)} bytes), "
        f"decompress_array {d_ms:.0f} ms (= the decoder on the stream's "
        f"symbols), with side {s_ms:.0f} ms (= decode_si on them)")
    return n_fronts, vols[0].shape, float(np.median(pass_ms))


def k3_pass_breakdown(codec, shape, pass_ms, rng, dev):
    """K3 device ms of one mode-3 pass (CUDA events at each bucket size of
    the pass's fronts, each beside its bound, times their count) beside the
    pass's host-clock ms and the bound of the pass (each front's real
    blocks, no padding): the rest is host work per front."""
    fronts = codec._wavefronts(*shape)
    top = max(len(f) for f in fronts)
    buckets = collections.Counter(codec_lib.front_bucket(len(f), top)
                                  for f in fronts)
    params = codec._front_kernel_engine().params
    blocks = torch.from_numpy(rng.choice(codec.centers, size=(top,)
                                         + pk.CONTEXT).astype(np.float32))
    blocks = blocks.to(dev)
    per_bucket = {b: cuda_ms(lambda: pk.probclass_front_logits(
        blocks[:b], params), 50) for b in sorted(buckets)}
    log("  K3 per bucket (blocks: fronts in the pass, kernel ms, bound us, "
        "share of bound): " + "; ".join(
            f"{b}: {buckets[b]}, {ms:.4f}, {1e3 * k3_bound(b, params)[0]:.4f}"
            f", {100 * k3_bound(b, params)[0] / ms:.1f}%"
            for b, ms in per_bucket.items()))
    kernel_ms = sum(buckets[b] * ms for b, ms in per_bucket.items())
    host_ms = pass_ms - kernel_ms
    bound_ms = sum(k3_bound(len(f), params)[0] for f in fronts)
    log(f"  mode-3 pass of {len(fronts)} fronts, {sum(map(len, fronts))} "
        f"blocks (buckets {dict(sorted(buckets.items()))}): bound "
        f"{bound_ms:.3f} ms; K3 device {kernel_ms:.2f} ms of "
        f"{pass_ms:.1f} ms ({100 * kernel_ms / pass_ms:.1f}%); the rest, "
        f"{1e3 * host_ms / len(fronts):.0f} us per front, is host work "
        f"(block gather, copies, launch, softmax + tables, rANS)")


def codec_phase(seed: int, dev):
    rng = np.random.default_rng(seed + 2)
    ae, pc = full_configs()
    server = DeviceServer(ae, pc, device=dev, seed=seed)
    codec = make_codec(server.model)
    shape = (ae.num_chan_bn, H // 8, W // 8)
    top = max(len(f) for f in codec._wavefronts(*shape))
    row = k3_phase(server.model, rng, dev, top)
    imgs = smooth_images(rng, 2, extra_w=64)
    x = np.clip(imgs[:, :, :W] + rng.normal(0, 4, (2, H, W, 3)),
                0, 255).astype(np.float32)
    y = imgs[0, :, 16:16 + W].copy()
    sk.reset_launch_counts()
    pk.reset_launch_counts()
    rans.reset_native_call_counts()
    n_fronts, shape, pass_ms = codec_path(server, codec, x, y, seed)
    launches = dict(pk.launch_counts, **sk.launch_counts)
    log(f"  codec path launches {launches} ({n_fronts} fronts per pass; "
        f"mode 3 runs 3 passes per volume: encode, decode, coding gap), "
        f"native coder calls {rans.native_call_counts()}")
    k3_pass_breakdown(codec, shape, pass_ms, rng, dev)
    return row, launches["probclass_front_logits"]


def k4_bound(x: torch.Tensor, wmat: torch.Tensor):
    """(bound_ms, bound_by) of one K4 call: the deconv's multiply-adds (25
    taps x Cin x 3 per input position, 1,200 per output pixel at Cin 64)
    and a 30-operation tail per output pixel over the peak rate of the
    operand type (float32 outside the tensor cores, bfloat16 dense) vs x,
    wmat, the folded affine and both float32 images over the memory rate."""
    n, h2, w2, cin = x.shape
    flops = 2.0 * n * h2 * w2 * 25 * cin * 3 + 30.0 * n * 4 * h2 * w2
    peak = BF16_PEAK if x.dtype == torch.bfloat16 else FP32_PEAK
    nbytes = (x.numel() * x.element_size() + wmat.numel() * wmat.element_size()
              + 4 * 18 + 2 * 4 * n * 4 * h2 * w2 * 3)
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k4_phase(seed: int, dev):
    """K4 against its plain version on the full-width decoder's activation
    before its last deconv, with the weights folded from that decoder, in
    float32 and bfloat16; timed beside its bound and the library chain.
    Returns the float32 row of the kernels line."""
    rng = np.random.default_rng(seed + 3)
    ae, pc = full_configs()
    model = build_model(ae, pc, device=dev, seed=seed)
    epi = ek.fold_epilogue_params(model.decoder, ae.normalization)
    dec = model.decoder
    x = torch.from_numpy(np.clip(smooth_images(rng, 2) + rng.normal(
        0, 4, (2, H, W, 3)), 0, 255).astype(np.float32)).to(dev)
    with torch.inference_mode():
        q = centers_lookup(model.centers, model.encode(x).symbols)
        act = dec.conv1(dec.res(dec.conv0(q.permute(0, 3, 1, 2))))
        x_pre = act.permute(0, 2, 3, 1).contiguous()
        x_dec = model.decode(q)
    if tuple(x_pre.shape) != (2, H // 2, W // 2, 64):
        raise AssertionError(f"decoder activation {tuple(x_pre.shape)}")
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        xs, wmat = x_pre.to(dtype), epi.wmat.to(dtype)
        operands = (xs, wmat) + tuple(epi[1:])
        img, srch = ek.fused_decode_epilogue(*operands)
        ref_img, ref_srch = ek.epilogue_reference(*operands)
        torch.testing.assert_close(img, ref_img, rtol=K4_RTOL, atol=K4_ATOL)
        torch.testing.assert_close(srch, ref_srch, rtol=K4_RTOL,
                                   atol=K4_ATOL)
        err = max(float((img - ref_img).abs().max()),
                  float((srch - ref_srch).abs().max()))
        one = ek.fused_decode_epilogue(xs[1:].contiguous(), *operands[1:])
        if not (torch.equal(one[0], img[1:]) and torch.equal(one[1],
                                                             srch[1:])):
            raise AssertionError(f"K4 {dtype}: image 1 alone differs from "
                                 f"image 1 of the batch")
        deconv = dec.conv2.conv.weight.detach().to(dtype)
        with torch.inference_mode():
            library = leg_lib.epilogue_library(xs, deconv, epi._replace(
                wmat=wmat))
        if dtype == torch.float32:
            torch.testing.assert_close(img, x_dec, rtol=K4_RTOL, atol=K4_ATOL)
            torch.testing.assert_close(library[0], img, rtol=K4_RTOL,
                                       atol=K4_ATOL)
        inside = float(((ref_img > 0) & (ref_img < 255)).float().mean())
        ms = cuda_ms(lambda: ek.fused_decode_epilogue(*operands), 50)
        plain_ms = cuda_ms(lambda: ek.epilogue_reference(*operands), 10)
        lib_ms = cuda_ms(lambda: leg_lib.epilogue_library(
            xs, deconv, epi._replace(wmat=wmat)), 10)
        b_ms, b_by = k4_bound(xs, wmat)
        name = str(dtype).replace("torch.", "")
        log(f"  K4 {name} at {tuple(xs.shape)}: max |kernel - plain| "
            f"{err:.3g} (rtol {K4_RTOL}, atol {K4_ATOL}), {100 * inside:.1f}%"
            f" of pixels inside the clip, image 1 alone bit-equal to the "
            f"batch's; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"(conv_transpose2d chain) {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {100 * b_ms / ms:.1f}% of bound")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    log("  K4 float32 image vs the decoder's own output (conv2 + BN + "
        "denorm + clip): within the same bound")
    return rows["float32"]


def leg_phase(seed: int, dev) -> int:
    """The serve-bench precision leg at full width; returns K4's launches
    in it."""
    sk.reset_launch_counts()
    pk.reset_launch_counts()
    ek.reset_launch_counts()
    t0 = time.perf_counter()
    section = leg_lib.run_precision_section(
        config_path("ae_kitti_stereo"), config_path("pc_default"), (H, W),
        LEG_REPS, seed=seed, device=dev)
    secs = time.perf_counter() - t0
    launches = dict(sk.launch_counts, **pk.launch_counts, **ek.launch_counts)
    violations = leg_lib.gate_precision(section)
    if violations:
        raise AssertionError(f"precision leg: {violations}")
    for name in ("pearson_argmax_shared", "probclass_front_logits",
                 "fused_decode_epilogue"):
        if launches[name] < 1:
            raise AssertionError(f"the precision leg did not launch {name}: "
                                 f"{launches}")
    log(f"  precision leg at {H}x{W}, batch {section['batch']}, median of "
        f"{section['reps']} (CUDA events), {secs:.1f} s, launches {launches}")
    log("  stage ms: " + " | ".join(
        f"{rung}: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                entry["stage_device_ms"].items())
        for rung, entry in section["per_rung"].items()))
    if seed == 0:
        for rung, entry in section["per_rung"].items():
            for mode, pin in STREAM_PINS.items():
                if not entry["stream_sha256"][mode].startswith(pin):
                    raise AssertionError(
                        f"precision leg {rung} {mode} stream sha256 "
                        f"{entry['stream_sha256'][mode][:16]}, pinned {pin}")
    digests = section["per_rung"]["fp32"]["stream_sha256"]
    log(f"  streams byte-identical across {section['rungs']}: "
        + ", ".join(f"{m} {digests[m][:16]}" for m in leg_lib.MODES)
        + ("" if seed else " (the pinned prefixes)")
        + "; every stream round-trips; steady builds "
        + str({r: e["steady_builds"]
               for r, e in section["per_rung"].items()}))
    return launches["fused_decode_epilogue"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[1/6] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    log("[2/6] build")
    build_phase()

    log(f"[3/6] kernel vs plain at {H}x{W}, patches {PH}x{PW}, seed "
        f"{args.seed}")
    rows = kernel_phase(args.seed, dev)

    log("[4/6] the slice at full width (ae_kitti_stereo + pc_default)")
    launches = slice_phase(args.seed, dev)

    log("[5/6] the codec at full width (ae_kitti_stereo + pc_default)")
    rows["probclass_front_logits"], launches["probclass_front_logits"] = \
        codec_phase(args.seed, dev)

    log("[6/6] the precision ladder: K4 and the serve-bench precision leg "
        "(ae_kitti_stereo + pc_default)")
    rows["fused_decode_epilogue"] = k4_phase(args.seed, dev)
    launches["fused_decode_epilogue"] = leg_phase(args.seed, dev)

    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name], **r)
               for name, r in rows.items()]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
