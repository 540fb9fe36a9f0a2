"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases; any failure raises, prints no result and exits non-zero:
  1. card check: needs torch.cuda; prints the card's name and power limit;
  2. build: builds csrc/sifinder_argmax.cu with nvcc, prints the build time
     and ptxas's register / shared-memory lines;
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
     (CUDA events); then the tiny configuration through the kernel on the
     card against the plain search on the CPU.
Then one line with the card, one JSON line with the kernels, and last the
result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dsin_tpu_torch.entry import entry, full_configs
from dsin_tpu_torch.models.quantizer import centers_lookup
from dsin_tpu_torch.ops import color as color_lib
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.ops import sifinder_kernel as sk
from dsin_tpu_torch.runtime import resolve_device
from dsin_tpu_torch.serve.device import DeviceServer

H, W, PH, PW = 320, 1224, 20, 24
FP32_PEAK = 67e12          # H100 SXM fp32 outside the tensor cores, 700 W
HBM_RATE = 3.35e12         # H100 SXM device memory, bytes/s
VAL_RTOL, VAL_ATOL = 1e-4, 1e-5   # fp32 sums in another order
MARGIN_ATOL = 1e-4         # indices equal where the top-two margin exceeds it
SOURCE = "dsin_tpu_torch/csrc/sifinder_argmax.cu"
REPLACES = {
    "pearson_argmax": "dsin_tpu/ops/sifinder_pallas.py:146",
    "pearson_argmax_shared": "dsin_tpu/ops/sifinder_pallas.py:340",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
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
    log(f"[1/4] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    lib = sk.load_library()
    regs = [ln.strip() for ln in lib.ptxas_log.splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"[2/4] build: {lib.build_seconds:.1f} s -> {lib.path}")
    for ln in regs:
        log(f"  ptxas: {ln}")

    log(f"[3/4] kernel vs plain at {H}x{W}, patches {PH}x{PW}, seed "
        f"{args.seed}")
    rows = kernel_phase(args.seed, dev)

    log("[4/4] the slice at full width (ae_kitti_stereo + pc_default)")
    launches = slice_phase(args.seed, dev)

    kernels = [dict(name=name, route="cuda", source=SOURCE,
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
