"""Seven legs of the serve bench (counterparts of the JAX package's
`tools/serve_bench.py`): the precision leg (`_run_precision_section`,
`_gate_precision`, :2334-2515), the entropy-backend leg
(`_run_backend_axis`, `_gate_backend_axis`, :484-575), the entropy half
of the transport leg (`_run_transport_section`, `_gate_transport`,
:2160-2233; its router half is not ported), the model-health leg
(`_run_quality_section`, :1062), the front-door legs
(`_run_frontdoor_overload`, `_run_frontdoor_replicas`, `_gate_frontdoor`,
:1268-1560), the elastic-fleet leg (`_run_autoscale_section`,
`_gate_autoscale`, :1563-1822) and the federated fleet leg
(`_run_federation_section`, `_gate_federation`, :1824-2064).

    python -m dsin_tpu_torch.tools.serve_bench --out F.json [--precision]
        [--entropy_backend both] [--transport both] [--quality]
        [--quality_requests N] [--quality_repeats N] [--device cpu]
        [--reps N] [--bucket H,W] [--ae_config P] [--pc_config P]
        [--buckets "H,W H,W"] [--shapes "H,W ..."] [--requests N]
        [--rate R] [--entropy_workers N] [--max_wait_ms MS]
        [--frontdoor_only] [--replicas N] [--priority_mix "C:S C:S"]
        [--interactive_slo_ms MS] [--bulk_deadline_ms MS]
        [--frontdoor_rate R] [--frontdoor_requests N] [--frontdoor_queue N]
        [--autoscale] [--federation_only] [--members N] [--smoke]

The entropy-backend leg serves one open-loop stream of encodes (`--requests`
at `--rate` a second over `--shapes`, then `--decode_samples` decodes; by
default 100 at 20/s, which outruns the card's service, so the queue (256
deep, none rejected) holds the service at saturation for most of the run and
`throughput_rps` reads its steady rate; the JAX leg sends 200) through one warm
`CompressionService` per backend, "thread" then "process", and records
throughput, the stage histograms, the overlap ratio, the warmup (child spawn
included), the children's pids and a two-thread probe of the host's free
cores (`effective_cores`); a probe set of images is then encoded through
both warm services, and `bit_identical` says whether their streams are
byte-equal. The transport leg does the same through the process backend on
"pipe" and on "shm" and records the lane counters; run after the backend
leg, it takes that leg's process run as its pipe run (the same
configuration, served once). Their gates hold only equality and health:
byte-equal streams, no native build in the stream window (the JAX leg's
compile sentinel), no failed request, no lane integrity error, lane sends on
shm. The output names the card (`nvidia-smi`) and the host's cores
(`os.cpu_count()` and the affinity mask): a served request is host-bound.

The front-door legs (`--frontdoor_only`): (1) overload through ONE
in-process service wearing priority classes and the admission gate
(`default_priority_classes(--frontdoor_queue)`, bulk's default deadline
`--bulk_deadline_ms`): `--frontdoor_requests` encodes open loop at
`--frontdoor_rate` a second, interactive and bulk interleaved by
`--priority_mix`; per class it records submissions, sheds at the door,
victims shed in the queue, expiries, completions, the gate's counters and
the latency quantiles (`serve_latency_ms_<cls>`), and the native builds in
the window. (2) the replica axis: the same mix at the same rate through a
`FrontDoorRouter` at 1 and `--replicas` spawned replica services on the
thread backend (on the card: all sharing it), requests/s, `scaling_vs_1`,
routing per replica, reroutes, each replica's start s and
`builds_at_ready`, and the probe images' streams from every replica, which
must be equal to each other's and across the runs (`bit_identical`).
`gate_frontdoor` holds: bulk shed first and only bulk, an interactive
request completed, no untyped or hung future, interactive p99 within
`--interactive_slo_ms` (the JAX gate's 1500 ms was set for its tiny
configuration: pass a value measured at full width, as `chip_smoke.py`
phase 13 does), no native build in the window or in a replica after its
ready handshake, bit-identity; the scaling floor (1.3) is a note on a host
without the cores, as in the JAX gate.

The fleet legs (`--autoscale`, `--federation_only`): `run_autoscale_section`
scales spawned thread-backend replicas 1 -> `--replicas` -> 1 under the
front-door mix and then admits a pre-warmed template; `gate_autoscale`
holds the scale counts, bit-identical streams at every size, no native
build after a replica's ready handshake or in this process, no untyped or
hung future, and the template's decision -> traffic within max(2 s, a
quarter of the cold admit) (a note in a serial window).
`run_federation_section` puts `--members` single-replica fleets (the
canary prober on) behind a `FederatedRouter`: both doors'
traffic and p50 / p99, one two-wave rollout to a second model with its
torn-version sweep, and the scrape fan-out; `gate_federation` holds them.
`--smoke` serves the chaos bench's tiny configuration at 32x48 with a few
requests (seconds of CPU).

The model-health leg (`--quality`) serves a mixed encode / decode /
decode_si stream (`--quality_requests` a pass, round-robin over the
shapes) through one warm SI service with the canary prober on: one pass
with the coding-gap sampler at 1.0 populates every per-bucket gap and bpp
histogram (and the SI-match scores where the search returns them: on the
CPU; on the card K2 folds them, and the leg says so), one explicit canary
probe, then `--quality_repeats` pairs of passes with telemetry on and off
at the default gap rate, in alternating order. `gate_quality` holds the
JSON contract, populated telemetry, a green canary and no native build;
the on/off overhead is recorded, not gated (a wall-clock gate fails on a
shared host).

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
import subprocess
import sys
import threading
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
from dsin_tpu_torch.serve import (BULK, INTERACTIVE, CompressionService,
                                  DeadlineExceeded, FrontDoorRouter,
                                  ServeError, ServiceConfig,
                                  ServiceOverloaded, default_priority_classes)

BATCH = 2
FRONT_BLOCKS = 64
MODES = ("wavefront_np", "wavefront_pl")
#: the service legs' batching, as chip_smoke.py phase 10 serves
LEG_MAX_BATCH, LEG_MAX_QUEUE, LEG_PIPELINE_DEPTH = 4, 256, 2
#: the federation leg's prober period: longer than the leg, so its probes
#: are the ones each commit wakes (the wave canary gate reads them)
FEDERATION_CANARY_EVERY_S = 600.0
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
                for_kernel=sifinder_lib.prep_for_kernel(cfg, dev),
                conv_dtype=sifinder_lib.sifinder_conv_dtype(cfg))
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


# -- the entropy-backend and transport legs -----------------------------------

def _parse_shapes(spec: str):
    return [tuple(int(v) for v in part.split(",")) for part in spec.split()]


def _build_service(args, backend: str = "thread", transport: str = "pipe"):
    """A started, warm service for the legs -> (service, warmup dict)."""
    service = CompressionService(ServiceConfig(
        ae_config=args.ae_config, pc_config=args.pc_config, seed=args.seed,
        buckets=_parse_shapes(args.buckets), max_batch=LEG_MAX_BATCH,
        max_wait_ms=args.max_wait_ms, max_queue=LEG_MAX_QUEUE,
        entropy_workers=args.entropy_workers, entropy_backend=backend,
        transport=transport, pipeline_depth=LEG_PIPELINE_DEPTH,
        device=args.device)).start()
    return service, service.warmup()


def _pace(i: int, t0: float, period: float) -> None:
    """Open-loop arrival pacing: sleep until request i's slot."""
    delay = t0 + i * period - time.monotonic()
    if delay > 0:
        time.sleep(delay)


def _run_stream(service, args) -> dict:
    """One open-loop pass of the request stream through a WARM service:
    `requests` encodes at `rate` a second, then `decode_samples` decodes
    of their streams; `steady_builds` counts native builds in the window."""
    rng = np.random.default_rng(args.seed)
    images = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
              for h, w in _parse_shapes(args.shapes)]
    futures, rejected, errors = [], 0, 0
    builds = native_build.build_count()
    period = 1.0 / args.rate
    t_start = time.monotonic()
    for i in range(args.requests):
        _pace(i, t_start, period)
        try:
            futures.append(service.submit_encode(images[i % len(images)]))
        except ServeError:
            rejected += 1
    t_submit_done = time.monotonic()
    for f in futures:
        try:
            f.result(timeout=600.0)
        except Exception:  # noqa: BLE001 — counted as failed
            errors += 1
    t_done = time.monotonic()
    decode_ok = 0
    for f in futures[:args.decode_samples]:
        if f.exception(timeout=0) is None:
            img = service.decode(f.result().stream, timeout=600.0)
            decode_ok += img.ndim == 3
    duration = t_done - t_start
    completed = len(futures) - errors
    return {"submitted": len(futures), "rejected_at_submit": rejected,
            "completed": completed, "failed": errors,
            "duration_s": round(duration, 4),
            "submit_window_s": round(t_submit_done - t_start, 4),
            "throughput_rps": round(completed / duration, 3)
            if duration > 0 else 0.0,
            "decode_roundtrips": decode_ok,
            "steady_builds": native_build.build_count() - builds}


def _mode_sections(service) -> dict:
    """The service's own stage metrics after a run."""
    snap = service.metrics.snapshot()
    hists, acc = snap["histograms"], snap.get("accumulators", {})

    def hist(name):
        return {k: round(float(v), 3) for k, v in hists.get(name, {}).items()}

    return {
        "latency_ms": hist("serve_latency_ms"),
        "batch_occupancy": {
            "mean": round(float(hists.get("serve_batch_occupancy",
                                          {}).get("mean", 0.0)), 4),
            "batches": snap["counters"].get("serve_batches", 0)},
        "stages": {
            "device_ms": hist("serve_device_ms"),
            "entropy_ms": hist("serve_entropy_ms"),
            "entropy_batch_ms": hist("serve_entropy_batch_ms"),
            "device_ms_total": round(acc.get("serve_device_ms_total", 0.0), 3),
            "entropy_ms_total": round(acc.get("serve_entropy_ms_total", 0.0),
                                      3),
            "busy_ms_total": round(acc.get("serve_busy_ms_total", 0.0), 3)},
        "overlap_ratio": round(snap["gauges"].get("serve_overlap_ratio", 0.0),
                               4),
    }


def _effective_cores(reps: int = 30) -> float:
    """Two-thread matmul throughput over one thread's (about 1.0: the host
    runs one thread at speed right now; about 2.0: two free cores)."""
    a = np.random.default_rng(0).random((192, 192))

    def rate(nthreads):
        def burn():
            for _ in range(reps):
                (a @ a).sum()
        ts = [threading.Thread(target=burn) for _ in range(nthreads)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return nthreads * reps / (time.perf_counter() - t0)

    r1 = rate(1)
    return rate(2) / r1 if r1 > 0 else 0.0


def _probe_images(args):
    rng = np.random.default_rng(args.seed + 1)
    shapes = _parse_shapes(args.shapes)
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in shapes[:3]]


def _shm_counters(counters) -> dict:
    out = {k: counters.get(f"serve_shm_{k}", 0)
           for k in ("sends", "bytes", "replies", "frees", "fallbacks",
                     "fallback_oversize", "fallback_exhausted")}
    out["integrity_errors"] = counters.get("serve_integrity_errors", 0)
    return out


def _leg_run(args, backend: str, transport: str, probes) -> tuple:
    """One warm service of the leg: the stream, then the probes encoded;
    -> (run entry, probe streams)."""
    svc, warm = _build_service(args, backend=backend, transport=transport)
    try:
        cores = round(_effective_cores(), 2)
        run = _run_stream(svc, args)
        frames = [svc.encode(im, timeout=600.0).stream for im in probes]
        pids = sorted({p["pid"] for p in svc._proc_warm})
    finally:
        svc.drain(timeout=600.0)
    sections = _mode_sections(svc)
    entry = {
        "throughput_rps": run["throughput_rps"],
        "completed": run["completed"], "failed": run["failed"],
        "steady_builds": run["steady_builds"],
        "decode_roundtrips": run["decode_roundtrips"],
        "entropy_workers": svc._entropy_workers,
        "warmup": {k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in warm.items()},
        "latency_ms": sections["latency_ms"],
        "stages": sections["stages"],
        "overlap_ratio": sections["overlap_ratio"],
        "effective_cores": cores,
        "worker_pids": pids,
        "shm": _shm_counters(svc.metrics.snapshot()["counters"]),
        "pool_rebuilds": svc.metrics.counter(
            "serve_entropy_proc_rebuilds").value,
    }
    return entry, frames


def run_backend_axis(args) -> tuple:
    """The entropy-backend leg: the same stream through one warm service
    per backend, "thread" then "process" (on the pipe), and the probe
    set's streams compared byte for byte (`bit_identical`). -> (section,
    the process run and its probe streams, which the transport leg
    reuses as its pipe run)."""
    probes = _probe_images(args)
    out = {"axis": ["thread", "process"], "runs": {}, "bit_identical": None}
    frames = {}
    for backend in out["axis"]:
        out["runs"][backend], frames[backend] = _leg_run(args, backend,
                                                         "pipe", probes)
    out["bit_identical"] = frames["thread"] == frames["process"]
    thread_rps = out["runs"]["thread"]["throughput_rps"]
    out["process_vs_thread"] = (
        round(out["runs"]["process"]["throughput_rps"] / thread_rps, 3)
        if thread_rps else None)
    return out, (out["runs"]["process"], frames["process"])


def gate_backend_axis(section) -> list:
    """Violations of the backend leg: streams that differ across backends,
    a native build in the stream window, a failed request."""
    violations = []
    if section["bit_identical"] is not True:
        violations.append("thread and process backends emitted different "
                          "bytes for the same probe images")
    for backend, entry in section["runs"].items():
        if entry["steady_builds"] != 0:
            violations.append(f"entropy_backend={backend}: "
                              f"{entry['steady_builds']} native builds in "
                              f"the stream window")
        if entry["failed"]:
            violations.append(f"entropy_backend={backend}: "
                              f"{entry['failed']} requests failed")
    return violations


def run_transport_section(args, pipe_run=None) -> dict:
    """The transport leg's entropy half: the same stream through the
    process backend on "pipe" and on "shm", the probe set's streams
    compared byte for byte, the lane counters of each run. `pipe_run`
    (run entry, probe streams) is the backend leg's process run, the same
    configuration, when that leg ran first."""
    probes = _probe_images(args)
    out = {"axis": ["pipe", "shm"],
           "entropy": {"runs": {}, "bit_identical": None}}
    frames = {}
    for transport in out["axis"]:
        if transport == "pipe" and pipe_run is not None:
            out["entropy"]["runs"]["pipe"], frames["pipe"] = pipe_run
            continue
        out["entropy"]["runs"][transport], frames[transport] = _leg_run(
            args, "process", transport, probes)
    out["entropy"]["bit_identical"] = frames["pipe"] == frames["shm"]
    pipe_rps = out["entropy"]["runs"]["pipe"]["throughput_rps"]
    out["entropy"]["shm_vs_pipe"] = (
        round(out["entropy"]["runs"]["shm"]["throughput_rps"] / pipe_rps, 3)
        if pipe_rps else None)
    return out


def gate_transport(section) -> list:
    """Violations of the transport leg: streams that differ across
    transports, a failed request, a native build in the stream window, a
    lane integrity error, or no lane send on shm (every payload fell back
    to the pipe: the lanes never ran)."""
    violations = []
    sub = section["entropy"]
    if sub["bit_identical"] is not True:
        violations.append("transport/entropy: pipe and shm emitted "
                          "different bytes for the same stream")
    for transport, entry in sub["runs"].items():
        if entry["failed"]:
            violations.append(f"transport/entropy {transport}: "
                              f"{entry['failed']} requests failed")
        if entry["steady_builds"]:
            violations.append(f"transport/entropy {transport}: "
                              f"{entry['steady_builds']} native builds in "
                              f"the stream window")
        if entry["shm"]["integrity_errors"]:
            violations.append(f"transport/entropy {transport}: "
                              f"{entry['shm']['integrity_errors']} integrity "
                              f"errors on a clean run")
    if sub["runs"]["shm"]["shm"]["sends"] == 0:
        violations.append("transport/entropy shm: zero lane sends — every "
                          "payload fell back to the pipe")
    return violations


def _quiesce(svc, timeout_s: float = 5.0) -> None:
    """Wait until the dataplane has published every batch it started
    (futures resolve before a worker publishes its batch's metrics)."""
    batches = svc.metrics.counter("serve_batches")
    gauge = svc.metrics.gauge("serve_pipeline_inflight")
    deadline = time.monotonic() + timeout_s
    last = -1
    while time.monotonic() < deadline:
        if gauge.value == 0 and svc._batcher.depth == 0:
            now = batches.value
            if now == last:
                return
            last = now
        time.sleep(0.05)


def run_quality_section(args) -> dict:
    """The model-health leg (see the module docstring) on ONE warm
    SI-enabled service with the canary prober on."""
    buckets = _parse_shapes(args.buckets)
    svc = CompressionService(ServiceConfig(
        ae_config=args.ae_config, pc_config=args.pc_config, seed=args.seed,
        buckets=buckets, max_batch=LEG_MAX_BATCH,
        max_wait_ms=args.max_wait_ms, max_queue=LEG_MAX_QUEUE,
        entropy_workers=args.entropy_workers,
        pipeline_depth=LEG_PIPELINE_DEPTH, enable_si=True,
        session_max=len(buckets) + 4, canary_every_s=0.4,
        device=args.device)).start()
    warm = svc.warmup()
    shapes = _parse_shapes(args.shapes)
    rng = np.random.default_rng(args.seed + 7)
    images = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
              for h, w in shapes]
    served = sorted({svc.policy.bucket_for(h, w) for h, w in shapes})
    sides = {b: rng.integers(0, 255, (b[0], b[1], 3), dtype=np.uint8)
             for b in served}
    n = args.quality_requests
    runs = {"on": [], "off": []}
    canary_result = {}
    builds = native_build.build_count()
    try:
        streams = [(svc.encode(img, timeout=600.0).stream,
                    svc.policy.bucket_for(*img.shape[:2])) for img in images]
        sids = {b: svc.open_session(sides[b]) for b in served}

        def one_pass():
            t0 = time.monotonic()
            for i in range(n):
                stream, bucket = streams[i % len(streams)]
                if i % 3 == 0:
                    svc.encode(images[(i // 3) % len(images)], timeout=600.0)
                elif i % 3 == 1:
                    svc.decode(stream, timeout=600.0)
                else:
                    svc.decode_si(stream, sids[bucket], timeout=600.0)
            _quiesce(svc)
            dur = time.monotonic() - t0
            return n / dur if dur > 0 else 0.0

        prev = svc.quality.set_gap_sample_rate(1.0)
        one_pass()
        svc.quality.set_gap_sample_rate(prev)
        for _ in range(200):
            canary_result = svc.run_canary()
            if canary_result.get("status") in ("ok", "failed"):
                break      # "busy": the prober holds the claim
            time.sleep(0.05)
        for r in range(args.quality_repeats):
            order = ["on", "off"] if r % 2 == 0 else ["off", "on"]
            for mode in order:
                svc.quality.set_enabled(mode == "on")
                runs[mode].append(round(one_pass(), 3))
        svc.quality.set_enabled(True)
        snap = svc.metrics.snapshot()
        si_summaries = svc.quality.si_session_summaries()
    finally:
        svc.drain(timeout=600.0)
    h, c = snap["histograms"], snap["counters"]

    def hist(name):
        return {k: round(float(v), 4)
                for k, v in h.get(name, {"count": 0, "mean": 0.0}).items()}

    ratios = [a / b for a, b in zip(runs["on"], runs["off"]) if b > 0]
    return {
        "requests_per_pass": n, "repeats": args.quality_repeats,
        "si_scores": svc._si_scores_enabled, "si_route": svc._si_route,
        "gap": {
            "sample_rate_default": svc.config.quality_gap_sample_rate,
            "samples": c.get("serve_coding_gap_samples", 0),
            "errors": c.get("serve_coding_gap_errors", 0),
            "per_bucket_pct": {f"{bh}x{bw}": hist(
                f"serve_coding_gap_pct_{bh}x{bw}") for bh, bw in served},
            "bits": hist("serve_coding_gap_bits")},
        "bpp": {f"{bh}x{bw}": {
            "payload": hist(f"serve_bpp_payload_{bh}x{bw}"),
            "wire": hist(f"serve_bpp_wire_{bh}x{bw}")} for bh, bw in served},
        "si_match": {
            "score": hist("serve_si_match_score"),
            "min_score": hist("serve_si_match_min_score"),
            "alarms": snap["gauges"].get("serve_si_match_alarms", 0),
            "alarm_transitions": c.get("serve_si_match_alarm_transitions",
                                       0),
            "sessions": si_summaries},
        "canary": {
            "result": canary_result,
            "runs": c.get("serve_canary_runs", 0),
            "failures": c.get("serve_canary_failures", 0),
            "errors": c.get("serve_canary_errors", 0),
            "races": c.get("serve_canary_races", 0),
            "ok": snap["gauges"].get("serve_canary_ok", 0),
            "probe_ms": hist("serve_canary_ms")},
        "runs": runs,
        "pair_ratios": [round(r, 4) for r in ratios],
        "overhead": (round(1.0 - statistics.median(ratios), 4)
                     if ratios else None),
        "steady_builds": native_build.build_count() - builds,
        "warmup": {k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in warm.items()},
    }


def gate_quality(section) -> list:
    """Violations of the model-health leg: a native build with telemetry
    on, empty or negative gap histograms, empty bpp histograms or no frame
    overhead, no SI-match scores where the search returns them, a canary
    that never ran or is not green. The on/off overhead is not gated."""
    violations = []
    if section["steady_builds"]:
        violations.append(f"quality leg: {section['steady_builds']} native "
                          f"builds with telemetry on")
    gap = section["gap"]
    if gap["samples"] < 1 or gap["errors"]:
        violations.append(f"coding-gap sampler: {gap['samples']} samples, "
                          f"{gap['errors']} errors")
    for key, hist in gap["per_bucket_pct"].items():
        if hist["count"] < 1:
            violations.append(f"gap histogram for bucket {key} is empty")
        elif hist.get("min", 0.0) < -0.5:
            violations.append(f"bucket {key} recorded a negative coding "
                              f"gap ({hist['min']}%)")
    for key, entry in section["bpp"].items():
        if entry["payload"]["count"] < 1 or entry["wire"]["count"] < 1:
            violations.append(f"bpp histograms for bucket {key} are empty")
        elif entry["wire"]["mean"] <= entry["payload"]["mean"]:
            violations.append(f"bucket {key}: wire bpp <= payload bpp")
    if section["si_scores"] and section["si_match"]["score"]["count"] < 1:
        violations.append("SI-match score histogram is empty")
    canary = section["canary"]
    if canary["runs"] < 1:
        violations.append("the canary never ran")
    if canary["failures"] or canary["ok"] != 1:
        violations.append(f"canary not green: {canary['failures']} "
                          f"failures, ok gauge {canary['ok']} (last: "
                          f"{canary.get('result')})")
    return violations


# -- the front-door legs ------------------------------------------------------

def _parse_mix(spec: str) -> dict:
    """'interactive:0.3 bulk:0.7' -> {class: share} (normalized)."""
    mix = {}
    for part in spec.split():
        name, share = part.split(":")
        mix[name] = float(share)
    total = sum(mix.values())
    if total <= 0 or any(v < 0 for v in mix.values()):
        raise ValueError(f"bad --priority_mix {spec!r}")
    return {k: v / total for k, v in mix.items()}


def _mixed_class(i: int, int_share: float) -> str:
    """Deterministic interactive/bulk interleave at the configured share
    (the same stream every run, no RNG)."""
    return (INTERACTIVE if int((i + 1) * int_share) > int(i * int_share)
            else BULK)


def _frontdoor_classes(args, max_queue):
    return default_priority_classes(max_queue,
                                    bulk_deadline_ms=args.bulk_deadline_ms)


def frontdoor_config(args, classes, **over) -> ServiceConfig:
    """The front-door legs' service: the legs' batching, `classes`, the
    given overrides."""
    kw = dict(ae_config=args.ae_config, pc_config=args.pc_config,
              seed=args.seed, buckets=_parse_shapes(args.buckets),
              max_batch=LEG_MAX_BATCH, max_wait_ms=args.max_wait_ms,
              max_queue=LEG_MAX_QUEUE, entropy_workers=args.entropy_workers,
              pipeline_depth=LEG_PIPELINE_DEPTH, priority_classes=classes,
              device=args.device)
    kw.update(over)
    return ServiceConfig(**kw)


def _frontdoor_images(args, seed_off: int):
    rng = np.random.default_rng(args.seed + seed_off)
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in _parse_shapes(args.shapes)]


def overload_service(args, **over) -> CompressionService:
    """The overload leg's started service: priority classes over a queue
    of --frontdoor_queue, the thread entropy backend unless `over` names
    another."""
    return CompressionService(frontdoor_config(
        args, _frontdoor_classes(args, args.frontdoor_queue),
        max_queue=args.frontdoor_queue, **over)).start()


def run_frontdoor_overload(args, images=None, svc=None, unloaded: int = 0,
                           slo_factor: float = 3.0) -> dict:
    """Open-loop OVERLOAD with a priority mix through ONE in-process service
    wearing the full front door (priority classes + admission gate):
    arrivals above capacity against a small queue, interactive and bulk
    interleaved by --priority_mix. Per class: sheds at the door (gate and
    queue bounds, both typed with the class), victims shed in the queue,
    expiries, completions, and the latency quantiles the gate holds
    interactive's p99 to. `images` (default: noise at --shapes) cycle.
    `svc`: a started, warm `overload_service` the caller drains (default:
    one built and drained here). With `unloaded` > 0 the SLO is measured
    first: that many interactive encodes of images[0], one at a time,
    and `slo_factor` times their median replaces --interactive_slo_ms
    (they are served requests of the class: its histogram holds them)."""
    own = svc is None
    warm = None
    if own:
        svc = overload_service(args)
    mix = _parse_mix(args.priority_mix)
    int_share = mix.get(INTERACTIVE, 0.0)
    if images is None:
        images = _frontdoor_images(args, 0)
    cores = round(_effective_cores(), 2)
    per = {cls: {"submitted": 0, "shed_at_door": 0, "completed": 0,
                 "shed_inflight": 0, "expired": 0, "failed": 0}
           for cls in (INTERACTIVE, BULK)}
    futures, unloaded_ms = [], []
    slo = args.interactive_slo_ms
    period = 1.0 / args.frontdoor_rate
    try:
        if own:
            warm = svc.warmup()
        builds = native_build.build_count()
        for _ in range(unloaded):
            t0 = time.monotonic()
            svc.encode(images[0], timeout=600.0, priority=INTERACTIVE)
            unloaded_ms.append((time.monotonic() - t0) * 1e3)
        if unloaded:
            slo = slo_factor * statistics.median(unloaded_ms)
        t_start = time.monotonic()
        for i in range(args.frontdoor_requests):
            _pace(i, t_start, period)
            cls = _mixed_class(i, int_share)
            per[cls]["submitted"] += 1
            try:
                futures.append((cls, svc.submit_encode(
                    images[i % len(images)], priority=cls)))
            except ServeError:
                per[cls]["shed_at_door"] += 1
        for cls, f in futures:
            try:
                exc = f.exception(timeout=600.0)
            except TimeoutError:
                per[cls]["failed"] += 1     # a hung future
                continue
            if exc is None:
                per[cls]["completed"] += 1
            elif isinstance(exc, ServiceOverloaded):
                per[cls]["shed_inflight"] += 1   # evicted as a victim
            elif isinstance(exc, DeadlineExceeded):
                per[cls]["expired"] += 1
            else:
                per[cls]["failed"] += 1
        duration = time.monotonic() - t_start
        steady_builds = native_build.build_count() - builds
        snap = svc.metrics.snapshot()
    finally:
        if own:
            svc.drain(timeout=600.0)
    for cls in per:
        lat = snap["histograms"].get(
            f"serve_latency_ms_{cls}",
            {"count": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0})
        per[cls]["latency_ms"] = {k: round(float(v), 3)
                                  for k, v in lat.items()}
        for key, name in (("shed_victims", "serve_shed_"),
                          ("admitted", "serve_admitted_"),
                          ("shed_admission", "serve_shed_admission_"),
                          ("expired_counted", "serve_expired_")):
            per[cls][key] = snap["counters"].get(f"{name}{cls}", 0)
    shed_total = {cls: per[cls]["shed_at_door"] + per[cls]["shed_inflight"]
                  for cls in per}
    return {
        "rate_rps": args.frontdoor_rate,
        "requests": args.frontdoor_requests,
        "queue": args.frontdoor_queue,
        "backend": svc.config.entropy_backend,
        "mix": mix,
        "duration_s": round(duration, 3),
        "per_class": per,
        "interactive_slo_ms": round(slo, 3),
        "unloaded_ms": [round(v, 3) for v in unloaded_ms],
        "interactive_p99_ms": per[INTERACTIVE]["latency_ms"]["p99"],
        "bulk_p99_ms": per[BULK]["latency_ms"]["p99"],
        "sheds_bulk_first": (shed_total[BULK] > 0
                             and shed_total[INTERACTIVE] == 0),
        "shed_total": shed_total,
        "effective_cores": cores,
        "steady_builds": steady_builds,
        "warmup": (None if warm is None else
                   {k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in warm.items()}),
    }


def resolve_futures(futures, timeout_s: float = 600.0) -> dict:
    """Resolve open-loop futures -> completed / typed refusals / failed
    (untyped or hung)."""
    completed = failed = rejected = 0
    for f in futures:
        try:
            exc = f.exception(timeout=timeout_s)
        except TimeoutError:
            failed += 1
            continue
        if exc is None:
            completed += 1
        elif isinstance(exc, ServeError):
            rejected += 1
        else:
            failed += 1
    return {"completed": completed, "rejected_inflight": rejected,
            "failed": failed}


def live_replicas(router) -> list:
    return sorted(int(i) for i, s in router.health()["replicas"].items()
                  if s == "live")


def replica_counts(router) -> dict:
    """Per replica, from the info entries of its scrape (AggregatedMetrics):
    native builds since its ready handshake (`serve_native_builds` less
    the handshake's `builds_at_ready`) and its kernel launches
    (`serve_kernel_launches`); None where the scrape failed."""
    per = router.aggregate.snapshot()["info"]["per_replica"]
    builds, launches = {}, {}
    for rep in router._all_replicas():
        info = per.get(str(rep.idx), {})
        now = info.get("serve_native_builds")
        ready = (rep.info or {}).get("builds_at_ready")
        builds[str(rep.idx)] = (None if now is None or ready is None
                                else now - ready)
        launches[str(rep.idx)] = info.get("serve_kernel_launches")
    return {"builds_after_ready": builds, "kernel_launches": launches}


def run_frontdoor_replicas(args, images=None, probes=None, config_over=None,
                           on_fleet=None) -> dict:
    """The shared-nothing scale-out axis: the same saturating mixed-class
    stream through the FrontDoorRouter at 1 and --replicas service
    processes (thread backend; on the card they share it). Records
    requests/s, routing per replica, reroutes, each replica's start s and
    `builds_at_ready`, the builds after it and its kernel launches, and
    the probe images' streams from every replica (each probe n times in a
    row, so round robin puts one copy on each replica; the JAX leg's
    order, the probes n times over, puts each probe on one replica when n
    equals their number): equal within a fleet and across the runs,
    `bit_identical`. `images` and `probes` default to noise at
    --shapes; `config_over` overrides the replicas' ServiceConfig;
    `on_fleet(n, router)`, when given, runs on each fleet after its
    numbers are read and before its drain."""
    classes = _frontdoor_classes(args, LEG_MAX_QUEUE)
    cfg = frontdoor_config(args, classes, entropy_backend="thread",
                           **(config_over or {}))
    mix = _parse_mix(args.priority_mix)
    int_share = mix.get(INTERACTIVE, 0.0)
    if images is None:
        images = _frontdoor_images(args, 2)
    if probes is None:
        probes = images[:2]
    axis = sorted({1, max(1, int(args.replicas))})
    out = {"axis": axis, "runs": {}, "bit_identical": None,
           "host_cores": os.cpu_count(),
           "affinity_cores": len(os.sched_getaffinity(0))}
    frames = {}
    for n in axis:
        cores = round(_effective_cores(), 2)
        t_start = time.monotonic()
        router = FrontDoorRouter(cfg, replicas=n).start()
        start_s = time.monotonic() - t_start
        try:
            futures, shed = [], 0
            period = 1.0 / args.frontdoor_rate
            t0 = time.monotonic()
            for i in range(args.frontdoor_requests):
                _pace(i, t0, period)
                try:
                    futures.append(router.submit_encode(
                        images[i % len(images)],
                        priority=_mixed_class(i, int_share)))
                except ServeError:
                    shed += 1
            resolved = resolve_futures(futures)
            completed, failed = resolved["completed"], resolved["failed"]
            rejected_inflight = resolved["rejected_inflight"]
            duration = time.monotonic() - t0
            # each probe n times in a row: round robin puts one copy on
            # every replica
            frames[n] = [[router.encode(im, timeout=600.0).stream
                          for _ in range(n)] for im in probes]
            counts = replica_counts(router)
            snap = router.metrics.snapshot()["counters"]
            infos = [dict(rep.info or {}) for rep in router._all_replicas()]
            digest = router.params_digest
            if on_fleet is not None:
                on_fleet(n, router)
        finally:
            router.drain(timeout_s=600.0)
        out["runs"][str(n)] = {
            "throughput_rps": round(completed / duration, 3)
            if duration > 0 else 0.0,
            "duration_s": round(duration, 3),
            "completed": completed,
            "failed": failed,
            "shed_at_door": shed,
            "rejected_inflight": rejected_inflight,
            "per_replica_routed": {
                str(i): snap.get(f"serve_router_routed_r{i}", 0)
                for i in range(n)},
            "reroutes": snap.get("serve_router_reroutes", 0),
            "replica_deaths": snap.get("serve_router_replica_deaths", 0),
            "router_start_s": round(start_s, 3),
            "replica_warmup_s": [round(i.get("warmup_s", 0.0), 3)
                                 for i in infos],
            "builds_at_ready": [i.get("builds_at_ready") for i in infos],
            **counts,
            "params_digest": digest,
            "effective_cores": cores,
        }
    first = [per_probe[0] for per_probe in frames[axis[0]]]
    same_within = all(len(set(per_probe)) == 1
                      for fleet in frames.values() for per_probe in fleet)
    same_across = all([per_probe[0] for per_probe in fleet] == first
                      for fleet in frames.values())
    out["bit_identical"] = bool(same_within and same_across)
    out["probe_streams"] = [hashlib.sha256(f).hexdigest() for f in first]
    base = out["runs"].get("1", {}).get("throughput_rps") or None
    for entry in out["runs"].values():
        entry["scaling_vs_1"] = (round(entry["throughput_rps"] / base, 3)
                                 if base else None)
    return out


def gate_frontdoor(section, scaling_floor: float = 1.3) -> tuple:
    """Violations of the front-door legs, and notes: the overload must shed
    bulk FIRST and only bulk, complete an interactive request, leave no
    untyped or hung future, hold interactive's p99 within its SLO and
    build nothing in the window; the replica axis must be bit-identical,
    fail no request and build nothing in a replica after its ready
    handshake. As in the JAX gate, a p99 over the SLO is a note when the
    host's effective cores read below 1.3 (a serial window), and a missed
    scaling floor is a note. -> (violations, notes)."""
    violations, notes = [], []
    ov = section.get("overload")
    if ov is not None:
        if not ov["sheds_bulk_first"]:
            violations.append(f"overload did not shed bulk first: shed "
                              f"totals {ov['shed_total']} (bulk must shed, "
                              f"interactive must not)")
        if ov["per_class"][INTERACTIVE]["completed"] == 0:
            violations.append("no interactive request completed under "
                              "overload")
        for cls, stats in ov["per_class"].items():
            if stats["failed"]:
                violations.append(f"overload: {stats['failed']} untyped/"
                                  f"hung {cls} requests")
        if ov["steady_builds"]:
            violations.append(f"overload: {ov['steady_builds']} native "
                              f"builds in the window")
        p99, slo = ov["interactive_p99_ms"], ov["interactive_slo_ms"]
        if not p99 or p99 > slo:
            cores = ov.get("effective_cores")
            msg = (f"interactive p99 {p99} ms exceeds its {slo} ms SLO "
                   f"while bulk was shedding (effective cores {cores})")
            if isinstance(cores, float) and cores < 1.3:
                # the JAX gate's host-weather escape: in a serial window
                # the classes share one core's worth of host, and the
                # latency class's coding waits on bulk's for the CPU
                notes.append(msg + ": a serial window, the SLO gate not "
                             "applied")
            else:
                violations.append(msg)
    reps = section.get("replicas")
    if reps is not None:
        if reps["bit_identical"] is not True:
            violations.append("replica fleet emitted non-identical streams "
                              "for the same probe images")
        for n, entry in reps["runs"].items():
            if entry["failed"]:
                violations.append(f"replicas={n}: {entry['failed']} "
                                  f"untyped/hung requests")
            bad = {i: b for i, b in entry["builds_after_ready"].items()
                   if b != 0}
            if bad:
                violations.append(f"replicas={n}: native builds after the "
                                  f"ready handshake {bad}")
        top = str(max(int(k) for k in reps["runs"]))
        if top != "1":
            entry = reps["runs"][top]
            scaling = entry.get("scaling_vs_1")
            if scaling is None or scaling < scaling_floor:
                cores = entry.get("effective_cores")
                host = reps.get("host_cores") or 0
                needed = 2 * int(top)
                msg = (f"{top}-replica scaling {scaling} below the "
                       f"{scaling_floor} floor (host cores {host}, "
                       f"effective cores {cores})")
                if host < needed or (isinstance(cores, float)
                                     and cores < 1.6):
                    notes.append(msg + " on a host without ~"
                                 f"{needed} cores of headroom")
                else:
                    notes.append(msg + ": each replica is a pipeline of "
                                 "several threads sharing one card")
    return violations, notes


def run_autoscale_section(args) -> dict:
    """The elastic-fleet leg (the JAX leg's `_run_autoscale_section`):
    scale 1 -> N -> 1 spawned replicas (thread backend; on the card all
    sharing it) under open-loop load through runtime `add_replica` and
    `drain_replica`, driven directly (the policy loop that issues them is
    `serve/autoscale.py`, held by the tests and the chaos battery). Per
    replica: `builds_at_ready` from its ready handshake and the native
    builds after it (its `serve_native_builds` less that), read before
    each drain (a drained replica's endpoint dies with it): the JAX leg's
    "zero compiles after ready" is "zero native builds after ready" here.
    The probe images' streams at every fleet size (each probe once per
    replica, round robin) must equal the 1-replica fleet's. Each admit
    records the seconds from the decision to its return (`admit_s`) and
    to one round-robin pass over the fleet (`decision_to_traffic_s`).
    Then a fresh router stocks a pre-warmed template and one
    `add_replica` must admit it: decision -> serving traffic through the
    template against the cold admit."""
    classes = _frontdoor_classes(args, LEG_MAX_QUEUE)
    cfg = frontdoor_config(args, classes, entropy_backend="thread")
    images = _frontdoor_images(args, 5)
    probes = images[:2]
    top = max(2, int(args.replicas))
    chunk = max(8, args.frontdoor_requests // 3)
    period = 1.0 / args.frontdoor_rate
    futures, load = [], {"shed": 0}
    streams = {}

    def run_chunk(router):
        t0 = time.monotonic()
        for i in range(chunk):
            _pace(i, t0, period)
            try:
                futures.append(router.submit_encode(images[i % len(images)]))
            except ServeError:
                load["shed"] += 1

    def probe(router, tag):
        n = router.health()["live"]
        streams[tag] = [[router.encode(im, timeout=600.0).stream
                         for _ in range(n)] for im in probes]

    out = {"top_replicas": top, "admits": [], "drains": [],
           "builds_after_ready": {}, "builds_at_ready": {}}
    steady = out["builds_after_ready"]

    def account(router):
        after = replica_counts(router)["builds_after_ready"]
        for i in live_replicas(router):
            steady[str(i)] = after.get(str(i))

    builds0 = native_build.build_count()
    router = FrontDoorRouter(cfg, replicas=1).start()
    try:
        probe(router, "start_1")
        run_chunk(router)
        for _ in range(2, top + 1):
            t0 = time.monotonic()
            info = router.add_replica()
            admit_s = time.monotonic() - t0
            probe(router, f"admit_{info['replica']}")
            out["admits"].append({
                "replica": info["replica"], "admit_s": round(admit_s, 3),
                "decision_to_traffic_s": round(time.monotonic() - t0, 3),
                "warmup_s": round(info.get("warmup_s") or 0.0, 3),
                "warmup_builds": info.get("warmup_builds"),
                "builds_at_ready": info.get("builds_at_ready")})
        probe(router, "top")
        run_chunk(router)
        while router.health()["live"] > 1:
            account(router)
            out["drains"].append(router.drain_replica())
        probe(router, "end_1")
        run_chunk(router)
        account(router)
        out.update(resolve_futures(futures))
        counters = router.metrics.snapshot()["counters"]
        out["builds_at_ready"] = {
            str(rep.idx): (rep.info or {}).get("builds_at_ready")
            for rep in router._all_replicas()}
    finally:
        router.drain(timeout_s=600.0)
    ref = [row[0] for row in streams["start_1"]]
    out["bit_identical"] = all(row == [want] * len(row)
                               for rows in streams.values()
                               for row, want in zip(rows, ref))
    out["probe_streams"] = [hashlib.sha256(s).hexdigest() for s in ref]
    out.update({
        "submitted": len(futures), "shed_at_door": load["shed"],
        "scale_ups": counters.get("serve_router_scale_ups", 0),
        "scale_downs": counters.get("serve_router_scale_downs", 0),
        "replica_deaths": counters.get("serve_router_replica_deaths", 0),
        "router_process_builds": native_build.build_count() - builds0})
    cold = out["admits"][0] if out["admits"] else {}
    tpl = {"cold_admit_s": cold.get("admit_s"),
           "cold_decision_to_traffic_s": cold.get("decision_to_traffic_s"),
           "effective_cores": round(_effective_cores(), 2),
           "host_cores": os.cpu_count()}
    router = FrontDoorRouter(cfg, replicas=1, prewarm_template=True).start()
    try:
        deadline = time.monotonic() + 600.0
        while not router.template_ready():
            if time.monotonic() > deadline:
                raise TimeoutError("autoscale: the replica template never "
                                   "stocked")
            time.sleep(0.05)
        t0 = time.monotonic()
        info = router.add_replica()
        # one round-robin pass lands a probe on each replica: the clock
        # stops once the admitted one has served
        first = [router.encode(im, timeout=600.0).stream for im in probes]
        tpl["decision_to_traffic_s"] = round(time.monotonic() - t0, 3)
        second = [router.encode(im, timeout=600.0).stream for im in probes]
        tpl["template_admit"] = bool(info.get("template_admit"))
        tpl["bit_identical"] = first == ref and second == ref
        tpl["builds_at_ready"] = info.get("builds_at_ready")
        tpl["builds_after_ready"] = replica_counts(router)[
            "builds_after_ready"].get(str(info["replica"]))
        counters = router.metrics.snapshot()["counters"]
        tpl["template_admits"] = counters.get("serve_template_admits", 0)
        tpl["template_misses"] = counters.get("serve_template_misses", 0)
    finally:
        router.drain(timeout_s=600.0)
    out["template"] = tpl
    return out


def gate_autoscale(section) -> tuple:
    """Violations of the elastic-fleet leg, and notes (the JAX leg's
    `_gate_autoscale` with builds for compiles): the fleet scaled 1 -> N
    -> 1, no replica built natively after its ready handshake (or left no
    evidence), the router process built nothing, the streams stayed
    bit-identical at every size, no future failed untyped or hung, no
    replica died; the template admit took the template, kept the bytes,
    built nothing after it and served within max(2 s, a quarter of the
    cold admit), a note on a host whose effective cores read below 1.3.
    -> (violations, notes)."""
    violations, notes = [], []
    want = section["top_replicas"] - 1
    for key in ("scale_ups", "scale_downs"):
        if section[key] != want:
            violations.append(f"autoscale: expected {want} {key}, saw "
                              f"{section[key]}")
    if section["failed"]:
        violations.append(f"autoscale: {section['failed']} untyped/hung "
                          f"requests across the scale cycle")
    if section["completed"] == 0:
        violations.append("autoscale: no request completed")
    if section["replica_deaths"]:
        violations.append(f"autoscale: {section['replica_deaths']} replica "
                          f"deaths during a graceful cycle")
    if section["bit_identical"] is not True:
        violations.append("autoscale: fleet streams diverged across "
                          "scale-up/drain (bit-identity lost)")
    for idx, n in section["builds_after_ready"].items():
        if n is None:
            violations.append(f"autoscale: replica {idx} left no build "
                              f"evidence (its scrape failed)")
        elif n:
            violations.append(f"autoscale: replica {idx} built {n} time(s) "
                              f"natively after its ready handshake")
    if section["router_process_builds"]:
        violations.append(f"autoscale: the router process built "
                          f"{section['router_process_builds']} time(s)")
    tpl = section.get("template")
    if tpl is not None:
        if not tpl.get("template_admit") or tpl.get("template_admits",
                                                    0) < 1:
            violations.append("autoscale: add_replica did not admit from "
                              "the pre-warmed template")
        if tpl.get("bit_identical") is not True:
            violations.append("autoscale: the template-admitted replica's "
                              "streams diverged from the fleet's")
        if tpl.get("builds_after_ready") != 0:
            violations.append(f"autoscale: template replica builds after "
                              f"ready {tpl.get('builds_after_ready')}")
        cold = tpl.get("cold_admit_s")
        budget = max(2.0, 0.25 * cold) if cold else 2.0
        dt = tpl.get("decision_to_traffic_s")
        if dt is None or dt > budget:
            msg = (f"autoscale: template decision->traffic {dt} s over its "
                   f"{round(budget, 3)} s budget (cold admit {cold} s)")
            if tpl.get("effective_cores", 99.0) < 1.3:
                notes.append(msg + f": effective cores "
                             f"{tpl.get('effective_cores')}, a serial "
                             f"window")
            else:
                violations.append(msg)
    return violations, notes


def run_federation_section(args) -> dict:
    """The federated fleet leg (the JAX leg's `_run_federation_section`):
    `--members` single-replica member fleets (spawned replicas, thread
    backend, the golden-canary prober on: every probe in the leg is the one
    a commit or a rollback wakes, FEDERATION_CANARY_EVERY_S exceeds it) behind
    one `FederatedRouter`. Measures routing through the federation's door
    against one member's own door (`--requests` at `--rate`, then 12
    sequential probes each way for p50 / p99), one two-wave rollout to a
    second model (wave m0, then the rest; each wave behind the canary gate
    and a 0.5 s soak; the checkpoint replicated into every member's root
    but m0's) from decision to convergence, followed by a sweep for torn
    versions, and one federated scrape against the members' scrapes in
    series. Every member must be bit-identical before and after the
    promotion, and neither this process nor a replica after its ready
    handshake may build natively."""
    import concurrent.futures as cf
    import tempfile

    from dsin_tpu_torch.serve.federation import (FederatedRouter, Member,
                                                 RolloutPlan)
    from dsin_tpu_torch.tools.chaos_bench import model_state
    from dsin_tpu_torch.train import checkpoint as ckpt_lib

    if args.members < 2:
        raise ValueError(f"--members must be >= 2 for two waves, got "
                         f"{args.members}")
    images = _frontdoor_images(args, 29)
    cfg = frontdoor_config(args, _frontdoor_classes(args, LEG_MAX_QUEUE),
                           entropy_backend="thread",
                           canary_every_s=FEDERATION_CANARY_EVERY_S,
                           quality_gap_sample_rate=1.0)
    tmpd = tempfile.mkdtemp(prefix="serve_fed_")
    state_b, extra = model_state(args, args.seed + 1, need_sinet=False)
    ckpt_b = os.path.join(tmpd, "ckpt_b")
    ckpt_lib.save_checkpoint(ckpt_b, state_b, manifest_extra={
        **extra, "buckets": [list(b) for b in cfg.buckets]})
    names = [f"m{i}" for i in range(args.members)]
    period = 1.0 / args.rate
    out = {"members": names, "replicas_per_member": 1}

    def lat_probe(door, n=12):
        lat = []
        for i in range(n):
            t = time.monotonic()
            door.encode(images[i % len(images)], timeout=600.0)
            lat.append((time.monotonic() - t) * 1e3)
        lat.sort()
        return (round(lat[len(lat) // 2], 3),
                round(lat[min(len(lat) - 1, int(len(lat) * 0.99))], 3))

    def one_pass(door):
        futures, shed = [], 0
        t0 = time.monotonic()
        for i in range(args.requests):
            _pace(i, t0, period)
            try:
                futures.append(door.submit_encode(images[i % len(images)]))
            except ServeError:
                shed += 1
        res = resolve_futures(futures)
        return {"submitted": args.requests, "shed_at_door": shed, **res,
                "wall_s": round(time.monotonic() - t0, 3)}

    def same_bytes(routers, fed, img):
        ref = routers[names[0]].encode(img, timeout=600.0).stream
        return ref, (all(routers[n].encode(img, timeout=600.0).stream == ref
                         for n in names)
                     and fed.encode(img, timeout=600.0).stream == ref)

    builds0 = native_build.build_count()
    with cf.ThreadPoolExecutor(len(names)) as pool:
        started = list(pool.map(
            lambda n: FrontDoorRouter(cfg, replicas=1).start(), names))
    routers = dict(zip(names, started))
    members = {n: Member(n, routers[n],
                         ckpt_root=(os.path.join(tmpd, f"root_{n}")
                                    if n != names[0] else None))
               for n in names}
    fed = FederatedRouter(list(members.values()), poll_every_s=0.25).start()
    try:
        digest_a = fed.params_digest
        _, ident_before = same_bytes(routers, fed, images[0])
        direct = one_pass(routers[names[0]])
        federated = one_pass(fed)
        d50, d99 = lat_probe(routers[names[0]])
        f50, f99 = lat_probe(fed)
        out["routing"] = {
            "direct": direct, "federated": federated,
            "direct_p50_ms": d50, "direct_p99_ms": d99,
            "federated_p50_ms": f50, "federated_p99_ms": f99,
            # > 1: the extra hop costs wall time; < 1 is as legitimate
            # (the federation round-robins over every member's fleet)
            "federation_hop_overhead": (
                round(federated["wall_s"] / direct["wall_s"], 3)
                if direct["wall_s"] else None)}
        plan = RolloutPlan(ckpt_dir=ckpt_b,
                           waves=((names[0],), tuple(names[1:])),
                           canary_timeout_s=600.0, poll_s=0.05, soak_s=0.5,
                           swap_timeout_s=600.0, rollback_timeout_s=60.0)
        t0 = time.monotonic()
        res = fed.rollout(plan)
        promote_s = time.monotonic() - t0
        digest_b = res["digest"]
        per_member = {n: routers[n].params_digest for n in names}
        _, ident_after = same_bytes(routers, fed, images[0])
        out["rollout"] = {
            "digest_a": digest_a, "digest_b": digest_b,
            "waves": res["waves"], "soak_s": plan.soak_s,
            "promote_s": round(promote_s, 3),
            "per_member_digests": per_member,
            "torn_versions": sorted(f"{n}={d!r}"
                                    for n, d in per_member.items()
                                    if d != digest_b),
            "distributed_roots_staged": {
                n: bool(ckpt_lib.latest_checkpoint(members[n].ckpt_root))
                for n in names[1:]}}
        serial_ms = []
        for n in names:
            t = time.monotonic()
            routers[n].aggregate.snapshot()
            serial_ms.append((time.monotonic() - t) * 1e3)
        t = time.monotonic()
        fed_snap = fed.aggregate.snapshot()
        fed_ms = (time.monotonic() - t) * 1e3
        out["scrape_fanout"] = {
            "member_scrape_ms": [round(v, 3) for v in serial_ms],
            "serial_sum_ms": round(sum(serial_ms), 3),
            "federated_ms": round(fed_ms, 3),
            "concurrency_ratio": (round(sum(serial_ms) / fed_ms, 3)
                                  if fed_ms else None),
            "members_scraped": fed_snap["info"]["members_scraped"],
            "members_unreachable": fed_snap["info"]["members_unreachable"]}
        out["bit_identical"] = {"before_rollout": ident_before,
                                "after_rollout": ident_after}
        out["builds_after_ready"] = {
            n: replica_counts(routers[n])["builds_after_ready"]
            for n in names}
        out["federation_counters"] = {
            k: v for k, v in fed.metrics.snapshot()["counters"].items()
            if k.startswith("federation")}
    finally:
        fed.drain()
        for n in names:
            routers[n].drain(timeout_s=600.0)
    out["bench_process_builds"] = native_build.build_count() - builds0
    return out


def gate_federation(section) -> list:
    """Violations of the federated fleet leg (the JAX leg's
    `_gate_federation`, builds for compiles): traffic through both doors
    completes with nothing hung or untyped; the rollout moves every member
    onto ONE new digest (no torn version) with the checkpoint staged in
    every member root, members bit-identical before and after; the
    federated scrape sees every member; no native build in this process
    or in a replica after its ready handshake."""
    violations = []
    for tag in ("direct", "federated"):
        leg = section["routing"][tag]
        if leg["failed"]:
            violations.append(f"federation: {leg['failed']} untyped/hung "
                              f"requests through the {tag} door")
        if leg["completed"] == 0:
            violations.append(f"federation: no request completed through "
                              f"the {tag} door")
    ro = section["rollout"]
    if ro["digest_b"] in (None, ro["digest_a"]):
        violations.append(f"federation: the staged rollout did not move "
                          f"the fleet ({ro['digest_a']} -> "
                          f"{ro['digest_b']})")
    if ro["torn_versions"]:
        violations.append(f"federation: torn versions after full "
                          f"promotion: {ro['torn_versions']}")
    if not all(ro["distributed_roots_staged"].values()):
        violations.append(f"federation: replicate_checkpoint left no "
                          f"checkpoint in member roots "
                          f"({ro['distributed_roots_staged']})")
    for when, ok in section["bit_identical"].items():
        if ok is not True:
            violations.append(f"federation: members were not "
                              f"bit-identical {when.replace('_', ' ')}")
    sf = section["scrape_fanout"]
    if (sf["members_scraped"] != len(section["members"])
            or sf["members_unreachable"]):
        violations.append(f"federation: the federated scrape missed "
                          f"members ({sf['members_scraped']} scraped, "
                          f"{sf['members_unreachable']} unreachable)")
    bad = {n: b for n, per in section["builds_after_ready"].items()
           for b in per.values() if b != 0}
    if bad:
        violations.append(f"federation: native builds after ready "
                          f"{section['builds_after_ready']}")
    if section["bench_process_builds"]:
        violations.append(f"federation: the bench process built "
                          f"{section['bench_process_builds']} time(s)")
    return violations


def host_line(device: str) -> dict:
    """The card (`nvidia-smi` name and power limit; None on the CPU) and the
    host's cores."""
    card = None
    if torch.device(device).type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return {"card": card, "cpu_count": os.cpu_count(),
            "affinity_cores": len(os.sched_getaffinity(0))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the port's serve bench: the "
                                "precision, entropy-backend and transport "
                                "legs")
    p.add_argument("--precision", action="store_true",
                   help="run the precision leg")
    p.add_argument("--entropy_backend", choices=("both",),
                   help="run the entropy-backend leg (thread vs process)")
    p.add_argument("--transport", choices=("both",),
                   help="run the transport leg (pipe vs shm, process "
                        "backend)")
    p.add_argument("--quality", action="store_true",
                   help="run the model-health leg (telemetry coverage, "
                        "canary, on/off overhead)")
    p.add_argument("--quality_requests", type=int, default=24)
    p.add_argument("--quality_repeats", type=int, default=3)
    p.add_argument("--out", required=True, help="JSON result file")
    p.add_argument("--ae_config", default=config_path("ae_kitti_stereo"))
    p.add_argument("--pc_config", default=config_path("pc_default"))
    p.add_argument("--bucket", default=None,
                   help="precision leg: H,W of the inputs (default: the AE "
                        "config's eval_crop_size)")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--buckets", default="160,600 320,1224",
                   help="service legs: the service's buckets")
    p.add_argument("--shapes", default="320,1224 300,1200 150,590",
                   help="service legs: request image shapes, cycled")
    p.add_argument("--requests", type=int, default=100)
    p.add_argument("--rate", type=float, default=20.0,
                   help="service legs: encode submits a second")
    p.add_argument("--decode_samples", type=int, default=4)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--entropy_workers", type=int, default=4)
    p.add_argument("--frontdoor_only", action="store_true",
                   help="run the front-door legs (priority-mix overload "
                        "and the replica axis)")
    p.add_argument("--replicas", type=int, default=2,
                   help="replica count of the front-door scale-out axis "
                        "(spawned replicas behind FrontDoorRouter; the axis "
                        "always includes 1)")
    p.add_argument("--priority_mix", default="interactive:0.125 bulk:0.875",
                   help="class shares of the front-door legs")
    p.add_argument("--interactive_slo_ms", type=float, default=1500.0,
                   help="p99 bound the overload gate holds interactive to")
    p.add_argument("--bulk_deadline_ms", type=float, default=30000.0,
                   help="bulk's default deadline in the front-door legs")
    p.add_argument("--frontdoor_rate", type=float, default=120.0,
                   help="the front-door legs' open-loop arrival rate")
    p.add_argument("--frontdoor_requests", type=int, default=240)
    p.add_argument("--frontdoor_queue", type=int, default=24,
                   help="the overload leg's queue bound (small: the shed "
                        "order needs a full queue)")
    p.add_argument("--autoscale", dest="autoscale_only", action="store_true",
                   help="run the elastic-fleet leg (1 -> --replicas -> 1 "
                        "spawned replicas under load, then a template "
                        "admit)")
    p.add_argument("--federation_only", action="store_true",
                   help="run the federated fleet leg (--members "
                        "single-replica fleets behind a FederatedRouter)")
    p.add_argument("--members", type=int, default=3,
                   help="member fleets of the federation leg")
    p.add_argument("--smoke", action="store_true",
                   help="the chaos bench's tiny configuration, 32x48 "
                        "buckets and a few requests: seconds of CPU")
    args = p.parse_args(argv)
    if not (args.precision or args.entropy_backend or args.transport
            or args.quality or args.frontdoor_only or args.autoscale_only
            or args.federation_only):
        p.error("choose a leg: --precision, --entropy_backend both, "
                "--transport both, --quality, --frontdoor_only, "
                "--autoscale or --federation_only")
    resolve_device(args.device)
    if args.smoke:
        import tempfile
        from dsin_tpu_torch.tools.chaos_bench import write_smoke_cfgs
        args.ae_config, args.pc_config = write_smoke_cfgs(tempfile.mkdtemp())
        args.buckets, args.shapes = "32,48", "32,48 24,32"
        args.requests, args.rate = 12, 200.0
        args.frontdoor_requests, args.frontdoor_rate = 24, 200.0
        args.entropy_workers = 1
    report = {"config": {"ae_config": args.ae_config,
                         "pc_config": args.pc_config, "seed": args.seed},
              "host": host_line(args.device)}
    violations = []
    if args.precision:
        if args.bucket:
            bucket = tuple(int(v) for v in args.bucket.split(","))
        else:
            bucket = parse_config_file(args.ae_config).get("eval_crop_size")
            if bucket is None:
                p.error("the AE config has no eval_crop_size: pass "
                        "--bucket H,W")
        report["precision"] = run_precision_section(
            args.ae_config, args.pc_config, bucket, args.reps,
            seed=args.seed, device=args.device)
        violations += gate_precision(report["precision"])
    if args.entropy_backend or args.transport:
        report["config"].update(
            buckets=args.buckets, shapes=args.shapes,
            requests=args.requests, rate=args.rate,
            entropy_workers=args.entropy_workers,
            pipeline_depth=LEG_PIPELINE_DEPTH, max_batch=LEG_MAX_BATCH)
    pipe_run = None
    if args.entropy_backend:
        report["backend"], pipe_run = run_backend_axis(args)
        violations += gate_backend_axis(report["backend"])
    if args.transport:
        report["transport"] = run_transport_section(args, pipe_run)
        violations += gate_transport(report["transport"])
    if args.quality:
        report["config"].update(
            buckets=args.buckets, shapes=args.shapes,
            quality_requests=args.quality_requests,
            quality_repeats=args.quality_repeats)
        report["quality"] = run_quality_section(args)
        violations += gate_quality(report["quality"])
    if args.frontdoor_only:
        report["config"].update(
            buckets=args.buckets, shapes=args.shapes,
            frontdoor_rate_rps=args.frontdoor_rate,
            frontdoor_requests=args.frontdoor_requests,
            frontdoor_queue=args.frontdoor_queue,
            priority_mix=args.priority_mix, replicas=args.replicas)
        report["frontdoor"] = {
            "overload": run_frontdoor_overload(args),
            "replicas": run_frontdoor_replicas(args)}
        fd_violations, notes = gate_frontdoor(report["frontdoor"])
        report["frontdoor"]["notes"] = notes
        for note in notes:
            print(f"SERVE_BENCH_NOTE: {note}", file=sys.stderr)
        violations += fd_violations
    if args.autoscale_only or args.federation_only:
        report["config"].update(
            buckets=args.buckets, shapes=args.shapes, smoke=args.smoke,
            replicas=args.replicas, members=args.members,
            requests=args.requests, rate=args.rate,
            frontdoor_rate_rps=args.frontdoor_rate,
            frontdoor_requests=args.frontdoor_requests)
    if args.autoscale_only:
        report["autoscale"] = run_autoscale_section(args)
        as_violations, notes = gate_autoscale(report["autoscale"])
        report["autoscale"]["notes"] = notes
        for note in notes:
            print(f"SERVE_BENCH_NOTE: {note}", file=sys.stderr)
        violations += as_violations
    if args.federation_only:
        report["federation"] = run_federation_section(args)
        violations += gate_federation(report["federation"])
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, args.out)
    print(json.dumps({k: v for k, v in report.items() if k != "config"},
                     indent=1))
    if violations:
        print(f"SERVE_BENCH_FAILED: {violations}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
