"""The serve bench's precision leg (counterpart of the JAX package's
`tools/serve_bench.py:2334-2515`, `_run_precision_section` and
`_gate_precision`).

    python -m dsin_tpu_torch.tools.serve_bench --precision --out F.json \\
        [--device cpu] [--reps N] [--bucket H,W] [--ae_config P] [--pc_config P]

For every rung of the precision ladder (`coding/precision.py`) the leg builds
the model with `load_model_state(precision=rung)` and times each serving
stage as the median over `reps` runs after one warm-up pass of every stage:
`encode`, `decode`, the probclass front through K3
(`probclass_front_kernel`) and through the model's masked `conv3d` stack on
the same 64 context blocks (`probclass_front_library`), the prepped search as
`DeviceServer.decode_si` runs it (`si_search`, K2 on the card), `sinet`, and
the fused decode epilogue through K4 (`epilogue_kernel`) and through
`F.conv_transpose2d` with crop, affine, clip and 3x3 map
(`epilogue_library`). The epilogue's operands are in the rung's compute
dtype (the JAX leg feeds float32 at every rung). On the card each time is
taken with CUDA events around synchronised work; on the CPU with the host
clock (`clock` in the result says which). `steady_builds` counts the native
builds during the timed window (the JAX leg's `steady_compiles`).

Then one symbol volume, drawn once, is encoded at every rung in modes 2
(numpy engine) and 3 (K3): the streams must be byte-identical across rungs,
because the cast never touches the entropy-critical partitions, and every
stream must decode to the volume. `gate_precision` turns the result into
violations; the command exits 1 on any. Like every entry point of the port it
runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dsin_tpu_torch import native_build
from dsin_tpu_torch.coding import precision as precision_lib
from dsin_tpu_torch.coding import probclass_kernel as pk
from dsin_tpu_torch.coding.loader import load_model_state, make_codec
from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.models import autoencoder as ae_lib
from dsin_tpu_torch.models.quantizer import centers_lookup
from dsin_tpu_torch.ops import epilogue as epi_lib
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.runtime import config_path, resolve_device

BATCH = 2
FRONT_BLOCKS = 64
MODES = ("wavefront_np", "wavefront_pl")
STAGES = ("encode", "decode", "probclass_front_kernel",
          "probclass_front_library", "si_search", "sinet", "epilogue_kernel",
          "epilogue_library")


def epilogue_library(x: torch.Tensor, weight: torch.Tensor,
                     epi: epi_lib.EpilogueParams):
    """K4's function as a chain of PyTorch calls: `F.conv_transpose2d` with
    the decoder's (flipped) `conv2` kernel `weight` in x's dtype, the "SAME"
    crop, then the folded affine, clip and 3x3 map in float32. The
    yardstick the leg times beside K4; the port never calls it."""
    _, h2, w2, _ = x.shape
    off = ae_lib._transpose_crop(epi_lib.K, 2)
    conv = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, stride=2)
    conv = conv[..., off:off + 2 * h2, off:off + 2 * w2].float()
    img = torch.clamp(conv.permute(0, 2, 3, 1) * epi.img_scale[0]
                      + epi.img_bias[0], 0.0, 255.0)
    srch = (img.reshape(-1, 3) @ epi.st_mat + epi.st_bias[0]).reshape(
        img.shape)
    return img, srch


def _median_ms(fn, reps: int, dev: torch.device) -> float:
    """Median ms of `reps` runs of fn(): CUDA events around synchronised
    work on the card, the host clock on the CPU."""
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def run_precision_section(ae_config: str, pc_config: str, bucket, reps: int,
                          seed: int = 0, device="cuda") -> dict:
    """Per-rung, per-stage ms and the cross-rung stream bit-identity of the
    configs at `bucket` (H, W), batch 2."""
    dev = resolve_device(device)
    bh, bw = (int(v) for v in bucket)
    reps = max(2, int(reps))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0.0, 255.0, (BATCH, bh, bw, 3))
                         .astype(np.float32)).to(dev)
    y_side = torch.from_numpy(rng.uniform(0.0, 255.0, (bh, bw, 3))
                              .astype(np.float32)).to(dev)
    fixed_sym = None       # one volume, shared by every rung
    per_rung = {}
    for rung in precision_lib.RUNGS:
        policy = precision_lib.PrecisionPolicy(rung)
        model = load_model_state(ae_config, pc_config, need_sinet=True,
                                 seed=seed, device=dev, precision=rung)
        cfg = model.ae_config
        ph, pw = (int(v) for v in cfg.y_patch_size)
        codec = make_codec(model)
        cdt = ae_lib.compute_dtype(cfg)
        with torch.inference_mode():
            sym = model.encode(x).symbols
            if fixed_sym is None:
                fixed_sym = rng.integers(
                    0, codec.num_centers,
                    size=(sym.shape[3], sym.shape[1], sym.shape[2])).astype(
                        np.int32)
            x_dec = model.decode(centers_lookup(model.centers, sym))
            y_syn = torch.from_numpy(rng.uniform(0.0, 255.0, x_dec.shape)
                                     .astype(np.float32)).to(dev)
            y_dec = model.decode(model.encode(y_side[None]).qbar)[0]
            factors = (sifinder_lib.gaussian_position_mask_factors(
                bh, bw, ph, pw) if bool(cfg.use_gauss_mask) else None)
            prep = sifinder_lib.build_side_prep(
                y_side, y_dec, ph, pw, mask_factors=factors,
                for_kernel=sifinder_lib.prep_for_kernel(cfg, dev))
        cd, cs, _ = codec.ctx_shape
        blocks = torch.from_numpy(rng.choice(
            codec.centers, size=(FRONT_BLOCKS, cd, cs, cs)).astype(
                np.float32)).to(dev)
        front = codec._front_kernel_engine().params
        epi = epi_lib.fold_epilogue_params(model.decoder, cfg.normalization)
        epi = epi._replace(wmat=epi.wmat.to(cdt))
        cin = epi.wmat.shape[0] // (epi_lib.K * epi_lib.K)
        x_pre = torch.from_numpy(rng.standard_normal(
            (BATCH, bh // 2, bw // 2, cin)).astype(np.float32)).to(dev, cdt)
        deconv = model.decoder.conv2.conv.weight.detach().to(cdt)

        stages = {
            "encode": lambda: model.encode(x).symbols,
            "decode": lambda: model.decode(centers_lookup(model.centers,
                                                          sym)),
            "probclass_front_kernel":
                lambda: pk.probclass_front_logits(blocks, front),
            "probclass_front_library":
                lambda: model.probclass(blocks[:, None]),
            "si_search": lambda: sifinder_lib.synthesize_side_image_prepped(
                x_dec, prep, ph, pw, cfg),
            "sinet": lambda: model.apply_sinet(x_dec, y_syn),
            "epilogue_kernel":
                lambda: epi_lib.fused_decode_epilogue(x_pre, *epi),
            "epilogue_library": lambda: epilogue_library(x_pre, deconv, epi),
        }
        with torch.inference_mode():
            for fn in stages.values():       # warm-up: builds land here
                fn()
            builds = native_build.build_count()
            stage_ms = {name: _median_ms(stages[name], reps, dev)
                        for name in STAGES}
            steady_builds = native_build.build_count() - builds

        streams, roundtrip = {}, {}
        for mode in MODES:
            stream = codec.encode(fixed_sym, mode=mode)
            streams[mode] = hashlib.sha256(stream).hexdigest()
            roundtrip[mode] = bool(np.array_equal(codec.decode(stream),
                                                  fixed_sym))
        per_rung[rung] = {
            "compute_dtype": policy.compute_dtype,
            "stage_device_ms": stage_ms,
            "steady_builds": steady_builds,
            "stream_sha256": streams,
            "roundtrip_ok": roundtrip,
        }
        del model, codec, stages
    identical = all(len({per_rung[r]["stream_sha256"][m]
                         for r in precision_lib.RUNGS}) == 1 for m in MODES)
    return {
        "rungs": list(precision_lib.RUNGS),
        "bucket": [bh, bw], "reps": reps, "batch": BATCH,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "clock": "cuda_events" if dev.type == "cuda" else "host",
        "per_rung": per_rung,
        "streams_bit_identical": identical,
    }


def gate_precision(section: dict) -> list:
    """Violations of the precision leg: a missing rung, a missing or
    non-positive stage time, a native build in the timed window, a stream
    that does not round-trip, or streams that differ across rungs (the rANS
    contract)."""
    violations = []
    per_rung = section.get("per_rung", {})
    for rung in precision_lib.RUNGS:
        if rung not in per_rung:
            violations.append(f"precision rung {rung} missing")
            continue
        entry = per_rung[rung]
        stage_ms = entry.get("stage_device_ms", {})
        for name in STAGES:
            ms = stage_ms.get(name)
            if not isinstance(ms, (int, float)) or ms <= 0:
                violations.append(f"precision[{rung}] stage {name} ms {ms!r}")
        if entry.get("steady_builds") != 0:
            violations.append(f"precision[{rung}] built "
                              f"{entry.get('steady_builds')!r} native "
                              f"libraries in the timed window")
        for mode in MODES:
            if entry.get("roundtrip_ok", {}).get(mode) is not True:
                violations.append(f"precision[{rung}] {mode} stream failed "
                                  f"to round-trip")
    if not section.get("streams_bit_identical"):
        digests = {r: e.get("stream_sha256") for r, e in per_rung.items()}
        violations.append(f"probclass stream divergence across rungs: "
                          f"{digests}")
    return violations


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the port's serve-bench "
                                "precision leg")
    p.add_argument("--precision", action="store_true", required=True,
                   help="run the precision leg (the only leg ported)")
    p.add_argument("--out", required=True, help="JSON result file")
    p.add_argument("--ae_config", default=config_path("ae_kitti_stereo"))
    p.add_argument("--pc_config", default=config_path("pc_default"))
    p.add_argument("--bucket", default=None,
                   help="H,W of the inputs (default: the AE config's "
                        "eval_crop_size)")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.bucket:
        bucket = tuple(int(v) for v in args.bucket.split(","))
    else:
        bucket = parse_config_file(args.ae_config).get("eval_crop_size")
        if bucket is None:
            p.error("the AE config has no eval_crop_size: pass --bucket H,W")
    report = {"config": {"ae_config": args.ae_config,
                         "pc_config": args.pc_config, "seed": args.seed},
              "precision": run_precision_section(
                  args.ae_config, args.pc_config, bucket, args.reps,
                  seed=args.seed, device=args.device)}
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, args.out)
    print(json.dumps(report["precision"], indent=1))
    violations = gate_precision(report["precision"])
    if violations:
        print(f"SERVE_BENCH_FAILED: {violations}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
