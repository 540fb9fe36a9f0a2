"""Ten legs of the serve bench (counterparts of the JAX package's
`tools/serve_bench.py`): the precision leg (`_run_precision_section`,
`_gate_precision`, :2334-2515), the SI leg (`_run_si_section`, `_gate_si`,
:617-806), the tracing leg (`_run_trace_section`, `_gate_trace`,
:829-1059), the entropy-backend leg
(`_run_backend_axis`, `_gate_backend_axis`, :484-575), the transport
leg, its router and its entropy half (`_run_transport_section`,
`_gate_transport`, :2067-2233), the model-health leg
(`_run_quality_section`, :1062), the front-door legs
(`_run_frontdoor_overload`, `_run_frontdoor_replicas`, `_gate_frontdoor`,
:1268-1560), the elastic-fleet leg (`_run_autoscale_section`,
`_gate_autoscale`, :1563-1822), the federated fleet leg
(`_run_federation_section`, `_gate_federation`, :1824-2064) and the device
axis (`_run_device_axis`, `_gate_device_axis`, :398-470, :575-600).

    python -m dsin_tpu_torch.tools.serve_bench --out F.json [--precision]
        [--entropy_backend both] [--transport both] [--quality]
        [--quality_requests N] [--quality_repeats N] [--device cpu]
        [--reps N] [--bucket H,W] [--ae_config P] [--pc_config P]
        [--buckets "H,W H,W"] [--shapes "H,W ..."] [--requests N]
        [--rate R] [--entropy_workers N] [--max_wait_ms MS]
        [--frontdoor_only] [--replicas N] [--priority_mix "C:S C:S"]
        [--interactive_slo_ms MS] [--bulk_deadline_ms MS]
        [--frontdoor_rate R] [--frontdoor_requests N] [--frontdoor_queue N]
        [--autoscale] [--federation_only] [--members N]
        [--devices "1 2 ..."] [--devices_only] [--si_only] [--trace]
        [--si_requests N] [--si_repeats N] [--trace_requests N]
        [--trace_repeats N] [--smoke]

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
byte-equal. The transport leg's router half sends the same stream through a
`FrontDoorRouter` over ONE spawned replica (thread backend) per transport,
"pipe" then "shm" (the payloads between the door and the replica pickled
on the pipe, or in shared-memory lanes with only a descriptor on the
pipe), and records throughput, the router's lane counters, each replica's
builds after its ready handshake and kernel launches, and `shm_vs_pipe`;
its entropy half does what the backend leg does through the process
backend on "pipe" and on "shm" and records the lane counters; run after
the backend leg, it takes that leg's process run as its pipe run (the same
configuration, served once). Their gates hold only equality and health:
byte-equal streams across transports, no native build in the stream window
(the JAX leg's compile sentinel), no failed request, no lane integrity
error, lane sends on shm; `shm_vs_pipe` gates only below the JAX leg's
broken-transport floor of 0.5 where the host's probes, before and after
each of the two runs, read parallel headroom. The output names the card (`nvidia-smi`) and the host's cores
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

The device axis (`--devices "1 2 4 8"`, alone with `--devices_only`;
`run_device_axis`) sends the legs' open-loop stream through one warm
thread-backend service per N, at N logical serve devices on `--device`
(`devices=("cpu",) * N` on the CPU, `("cuda:0",) * N` on the card: each with
its own copy of the weights and its own worker streams, all on one card).
Per N: throughput and `scaling_vs_1`, the bucket -> device census, the
executable census, per device its batches, busy ms and occupancy (busy over
the pass's wall), `all_devices_served`, and the native builds in the stream
window. Several logical devices on one card or one CPU share it, so the
scaling is a record, not a claim. `gate_device_axis` holds: no build in
the window, no failed request, every device served at N > 1, and under
`--smoke` no skipped N (an N the service refuses is skipped and recorded).

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

The SI leg (`--si_only`; `run_si_section`) serves `--si_requests` decode_si
requests a pass (round-robin over --shapes) through one warm SI service in
`--si_repeats` pairs of a warm-session pass (a session a bucket, opened
before the pass) and a per-request-prep pass (`open_session`, `decode_si`,
`close_session` a request), in alternating order; `speedup` is the median
of the pairs' throughput ratios. Then the churn opens 12 sessions past
`session_max` = 4, decoding the newest 6 after each open, and counts the
store's evictions by reason. The tracing leg (`--trace`;
`run_trace_section`) serves one mixed encode / decode / decode_si pass
(`--trace_requests`) in `--trace_repeats` pairs of a traced pass (sample
rate 1.0, the flight recorder on) and an untraced one, cross-checks the
spans' summed ms per stage against the service's accumulators and its
`serve_si_search_ms` histogram, reads one sampled decode_si trace back over
`/trace` and makes a typed error dump the flight recorder. `gate_si` and
`gate_trace` hold the JAX gates' hard checks in every mode (no failure, no
native build, evictions and no untyped error in the churn, the drift within
max(10%, 5 ms), the five span names, a flight dump); their speed floors (the
1.1 warm speedup; the 2% overhead budget with its 0.05 pair-spread escape
and its 25% broken band) only under `--smoke`, where a free-core probe under
1.3 before or after any pair turns a missed floor into a note. The two legs
run without the other legs; under `--smoke` they serve the JAX smoke's
shapes (32x48, 48x96, 64x96) and buckets (48x96, 64x96) with 20 and 18
requests a pass.

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
import tempfile
import threading
import time
import urllib.request
from typing import Optional

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
                                  PlacementError, ServeError, ServiceConfig,
                                  ServiceOverloaded, SessionError,
                                  default_priority_classes)
from dsin_tpu_torch.serve import trace as trace_lib

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


def _leg_config(args, backend: str = "thread",
                transport: str = "pipe", devices=None,
                **over) -> ServiceConfig:
    """The service legs' configuration (phase 10's batching), with `over`
    set on top."""
    return ServiceConfig(
        ae_config=args.ae_config, pc_config=args.pc_config, seed=args.seed,
        buckets=_parse_shapes(args.buckets), max_batch=LEG_MAX_BATCH,
        max_wait_ms=args.max_wait_ms, max_queue=LEG_MAX_QUEUE,
        entropy_workers=args.entropy_workers, entropy_backend=backend,
        transport=transport, pipeline_depth=LEG_PIPELINE_DEPTH,
        device=args.device, devices=devices, **over)


def _build_service(args, backend: str = "thread", transport: str = "pipe",
                   devices=None, **over):
    """A started, warm service for the legs -> (service, warmup dict)."""
    service = CompressionService(_leg_config(args, backend, transport,
                                             devices, **over)).start()
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
    images = _stream_images(args)
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


def logical_devices(device: str, n: int) -> tuple:
    """N logical serve devices on the first device of `device`'s type:
    ("cpu",) * N, or ("cuda:0",) * N on the card."""
    dev = torch.device(device)
    name = "cpu" if dev.type == "cpu" else f"{dev.type}:{dev.index or 0}"
    return (name,) * n


def run_device_axis(args, axis) -> dict:
    """The device axis: the legs' open-loop stream through one warm
    thread-backend service per N of `axis`, at N logical devices
    (`logical_devices`). Per N the throughput, the census, per-device
    batches / busy ms / occupancy (busy over the pass's whole wall:
    stream, decodes and the drain's flush, during all of which busy time
    lands), `all_devices_served` and the builds in the stream window;
    `scaling_vs_1` against the N=1 run. An N the service refuses
    (PlacementError) is skipped and recorded."""
    out = {"axis": list(axis), "skipped": {}, "runs": {}}
    for n in axis:
        devices = logical_devices(args.device, n)
        try:
            svc, warm = _build_service(args, devices=devices)
        except PlacementError as e:
            out["skipped"][str(n)] = str(e)
            print(f"SERVE_BENCH_NOTE: skipping devices={n}: {e}",
                  file=sys.stderr)
            continue
        t_wall = time.monotonic()
        try:
            run = _run_stream(svc, args)
        finally:
            # drain BEFORE reading the per-device ledgers: a pipelined
            # executor publishes a batch's busy ms and count at its finish,
            # after the batch's futures resolve
            svc.drain(timeout=600.0)
        wall_ms = (time.monotonic() - t_wall) * 1e3
        snap = svc.metrics.snapshot()
        per_device = {}
        for d in range(n):
            batches = snap["counters"].get(f"serve_device_batches_d{d}", 0)
            busy = snap["accumulators"].get(f"serve_device_busy_ms_d{d}",
                                            0.0)
            per_device[str(d)] = {
                "batches": batches, "busy_ms": round(busy, 3),
                "occupancy": round(busy / wall_ms, 4) if wall_ms > 0
                else 0.0}
        out["runs"][str(n)] = {
            "devices": list(devices),
            "throughput_rps": run["throughput_rps"],
            "completed": run["completed"], "failed": run["failed"],
            "decode_roundtrips": run["decode_roundtrips"],
            "steady_builds": run["steady_builds"],
            "warmup": {k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in warm.items()},
            "census": snap["info"].get("serve_device_assignments", {}),
            "executable_census": snap["gauges"].get(
                "serve_executable_census", 0),
            "per_device": per_device,
            "all_devices_served": all(v["batches"] > 0
                                      for v in per_device.values())}
    # the baseline is the N=1 run itself, whatever leads the axis; without
    # one the ratio is unavailable (null)
    base_rps = out["runs"].get("1", {}).get("throughput_rps") or None
    for entry in out["runs"].values():
        entry["scaling_vs_1"] = (round(entry["throughput_rps"] / base_rps, 3)
                                 if base_rps else None)
    return out


def gate_device_axis(section, smoke: bool = False) -> list:
    """Violations of the device axis: a native build in the stream window
    at any N, a device that served nothing at N > 1 (the placement left a
    device idle), a failed request, and under `smoke` a skipped N (the
    smoke axis must actually run)."""
    violations = []
    if smoke:
        for n, why in section.get("skipped", {}).items():
            violations.append(f"devices={n} was skipped ({why}) — the "
                              f"smoke axis must actually run")
    for n, entry in sorted(section["runs"].items(),
                           key=lambda kv: int(kv[0])):
        if entry["steady_builds"] != 0:
            violations.append(f"devices={n}: {entry['steady_builds']} "
                              f"native builds in the stream window")
        if int(n) > 1 and not entry["all_devices_served"]:
            idle = [d for d, v in entry["per_device"].items()
                    if v["batches"] == 0]
            violations.append(f"devices={n}: devices {idle} served zero "
                              f"batches (census {entry['census']})")
        if entry["failed"]:
            violations.append(f"devices={n}: {entry['failed']} requests "
                              f"failed")
    return violations


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


def _stream_images(args):
    """The legs' request images (`_run_stream`'s, from `args.seed`)."""
    rng = np.random.default_rng(args.seed)
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in _parse_shapes(args.shapes)]


def router_transport_routers(args) -> dict:
    """The router half's two routers, "pipe" and "shm", each as a
    zero-argument callable that builds and starts it (ONE spawned replica,
    thread backend). A caller may start them ahead of the leg and pass
    callables that hand over the started routers."""
    cfg = _leg_config(args)
    return {t: (lambda t=t: FrontDoorRouter(cfg, replicas=1,
                                            transport=t).start())
            for t in ("pipe", "shm")}


def _router_run(args, start, images, probes) -> tuple:
    """One run of the router half through the router `start()` gives:
    the open-loop stream of `_run_stream` (over `images`) through the
    door, `decode_samples` of its streams decoded back, then the probes
    encoded. The host's free cores are probed before the router starts
    (`effective_cores`) and again once the stream resolved
    (`effective_cores_after`): a load that arrives during the run shows
    in the second. -> (run entry, probe streams)."""
    cores = round(_effective_cores(), 2)
    router = start()
    try:
        futures, shed = [], 0
        period = 1.0 / args.rate
        t0 = time.monotonic()
        for i in range(args.requests):
            _pace(i, t0, period)
            try:
                futures.append(router.submit_encode(images[i % len(images)]))
            except ServeError:
                shed += 1
        completed = failed = 0
        streams = []
        for f in futures:
            try:
                exc = f.exception(timeout=600.0)
            except TimeoutError:
                failed += 1
                continue
            if exc is None:
                completed += 1
                if len(streams) < args.decode_samples:
                    streams.append(f.result().stream)
            else:
                failed += 1
        duration = time.monotonic() - t0
        cores_after = round(_effective_cores(), 2)
        roundtrips = sum(1 for s in streams
                         if router.decode(s, timeout=600.0) is not None)
        frames = [router.encode(im, timeout=600.0).stream for im in probes]
        counters = router.metrics.snapshot()["counters"]
        replicas = replica_counts(router)
    finally:
        router.drain(timeout_s=60)
    shm = {k: counters.get(f"serve_shm_{k}", 0)
           for k in ("sends", "bytes", "frees", "fallbacks",
                     "fallback_oversize", "fallback_exhausted",
                     "integrity_errors")}
    return {"throughput_rps": round(completed / duration, 3)
            if duration > 0 else 0.0,
            "completed": completed, "failed": failed, "shed_at_door": shed,
            "duration_s": round(duration, 4),
            "decode_roundtrips": roundtrips, "shm": shm,
            "effective_cores": cores, "effective_cores_after": cores_after,
            "host_cores": os.cpu_count(),
            "replica_builds_after_ready": replicas["builds_after_ready"],
            "replica_kernel_launches": replicas["kernel_launches"]}, frames


def run_router_transport(args, images=None, probes=None,
                         routers=None) -> dict:
    """The transport leg's router half: the same stream through one
    spawned replica per transport, "pipe" then "shm"; the probes' streams
    compared byte for byte (`bit_identical`), `shm_vs_pipe` as evidence.
    `images` and `probes` default to the legs' noise (`_stream_images`,
    `_probe_images`), `routers` to `router_transport_routers(args)`."""
    images = _stream_images(args) if images is None else images
    probes = _probe_images(args) if probes is None else probes
    starters = (routers if routers is not None
                else router_transport_routers(args))
    out = {"runs": {}, "bit_identical": None}
    frames = {}
    for transport in ("pipe", "shm"):
        out["runs"][transport], frames[transport] = _router_run(
            args, starters[transport], images, probes)
    out["bit_identical"] = frames["pipe"] == frames["shm"]
    pipe_rps = out["runs"]["pipe"]["throughput_rps"]
    out["shm_vs_pipe"] = (round(out["runs"]["shm"]["throughput_rps"]
                                / pipe_rps, 3) if pipe_rps else None)
    return out


def gate_router_transport(sub) -> list:
    """Violations of the router half (the JAX leg's): streams that differ
    across transports, a failed or hung request, a lane integrity error,
    no lane send on shm, and shm below half of pipe's throughput where
    the host's probes read parallel headroom around both runs of the
    ratio (a note in a serial window: any probe, before or after either
    run, under 1.3, the JAX leg's per-pair convention)."""
    violations = []
    if sub["bit_identical"] is not True:
        violations.append("transport/router: pipe and shm emitted "
                          "different bytes for the same stream — the "
                          "transport changed the payload")
    for transport, entry in sub["runs"].items():
        if entry["failed"]:
            violations.append(f"transport/router {transport}: "
                              f"{entry['failed']} untyped/hung requests")
        if entry["shm"]["integrity_errors"]:
            violations.append(f"transport/router {transport}: "
                              f"{entry['shm']['integrity_errors']} lane "
                              f"integrity errors on a clean run")
    shm_run = sub["runs"]["shm"]
    if shm_run["shm"]["sends"] == 0:
        violations.append("transport/router shm: zero lane sends — every "
                          "payload fell back inline; the lane transport "
                          "never ran")
    ratio = sub.get("shm_vs_pipe")
    if ratio is not None and ratio < 0.5:
        cores = _window_cores(sub["runs"].values())
        if cores is not None and cores < 1.3:
            print(f"SERVE_BENCH_NOTE: shm router throughput {ratio}x pipe "
                  f"in a serial window (effective cores {cores}) — "
                  f"transport floor not applied", file=sys.stderr)
        else:
            violations.append(f"transport/router: shm at {ratio}x pipe with "
                              f"parallel headroom (effective cores {cores})"
                              f" — below the broken-transport floor 0.5")
    return violations


def _window_cores(runs) -> Optional[float]:
    """The least of the free-core probes taken around `runs` (before and
    after each), None when none was recorded: a ratio of two runs has
    parallel headroom only if every window it was measured in had."""
    probes = [run.get(k) for run in runs
              for k in ("effective_cores", "effective_cores_after")]
    probes = [c for c in probes if isinstance(c, (int, float))]
    return min(probes) if probes else None


def run_transport_section(args, pipe_run=None) -> dict:
    """The transport leg, both halves in the JAX leg's order: the router
    half (`run_router_transport`), then the entropy half, the same stream
    through the process backend on "pipe" and on "shm", the probe set's
    streams compared byte for byte, the lane counters of each run.
    `pipe_run` (run entry, probe streams) is the backend leg's process
    run, the same configuration, when that leg ran first."""
    probes = _probe_images(args)
    out = {"axis": ["pipe", "shm"], "router": run_router_transport(args),
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
    """Violations of the transport leg: the router half's
    (`gate_router_transport`), then the entropy half's: streams that
    differ across transports, a failed request, a native build in the
    stream window, a lane integrity error, or no lane send on shm (every
    payload fell back to the pipe: the lanes never ran)."""
    violations = gate_router_transport(section["router"])
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


# -- the SI leg and the tracing leg -------------------------------------------

#: the SI leg's store bound (the JAX leg's `session_max=4`)
SI_SESSION_MAX = 4
#: the SI churn: sessions opened under load, alternating buckets, and the
#: newest of them decoded after each open (the JAX leg's 3 * 4 and
#: `sids[-6:]`)
SI_CHURN_OPENS, SI_CHURN_WINDOW = 3 * 4, 6
#: the tracing leg's span ring: every span of a traced pass fits
TRACE_CAPACITY = 32768
#: the JAX gates' speed floors, held under --smoke: the warm-session
#: speedup, and the tracing overhead's budget and its broken band
SI_FLOOR, TRACE_BUDGET, TRACE_BROKEN = 1.1, 0.02, 0.25
#: the spans a sampled decode_si trace must hold
SI_TRACE_SPANS = (trace_lib.SPAN_QUEUE, trace_lib.SPAN_DEVICE,
                  trace_lib.SPAN_ENTROPY, trace_lib.SPAN_SESSION,
                  trace_lib.SPAN_SI_SEARCH)


def _median(xs) -> float:
    return float(statistics.median(xs)) if xs else 0.0


def _lat_stats(samples_ms) -> dict:
    if not samples_ms:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0}
    xs = sorted(samples_ms)
    return {"count": len(xs),
            "mean": round(sum(xs) / len(xs), 3),
            "p50": round(xs[len(xs) // 2], 3),
            "p99": round(xs[min(len(xs) - 1,
                               int(round(0.99 * (len(xs) - 1))))], 3)}


def _rounded(warm) -> Optional[dict]:
    """A warmup dict with its floats rounded (None stays None)."""
    return None if warm is None else {
        k: (round(v, 4) if isinstance(v, float) else v)
        for k, v in warm.items()}


def _pair_cores(section) -> Optional[float]:
    """`_window_cores` over a leg's pairs: the least of the free-core
    probes taken before and after each pair, None when none was."""
    return _window_cores(
        {"effective_cores": before, "effective_cores_after": after}
        for before, after in zip(
            section.get("pair_effective_cores") or (),
            section.get("pair_effective_cores_after") or ()))


def _leg_traffic(args, svc, seed_off: int, images=None, streams=None,
                 sides=None) -> tuple:
    """The SI and tracing legs' traffic through `svc`: an image a shape of
    --shapes (noise from `args.seed + seed_off`, the JAX legs' draws,
    unless `images` gives them), the buckets they route to, a side image a
    bucket (`sides` or noise) and a stream a shape, {(h, w): (stream,
    bucket)}, each image encoded once unless `streams` gives them.
    -> (shapes, images, buckets, sides, streams)."""
    shapes = _parse_shapes(args.shapes)
    rng = np.random.default_rng(args.seed + seed_off)
    noise = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
             for h, w in shapes]
    buckets = sorted({svc.policy.bucket_for(h, w) for h, w in shapes})
    drawn = {b: rng.integers(0, 255, (b[0], b[1], 3), dtype=np.uint8)
             for b in buckets}
    images = noise if images is None else images
    if streams is None:
        streams = {(h, w): (svc.encode(images[shapes.index((h, w))],
                                       timeout=600.0).stream,
                            svc.policy.bucket_for(h, w))
                   for h, w in shapes}
    return shapes, images, buckets, drawn if sides is None else sides, \
        streams


def _eviction_counts(svc) -> dict:
    """The store's evictions so far by reason (`serve_session_evictions_<reason>`)."""
    prefix = "serve_session_evictions_"
    return {k[len(prefix):]: v
            for k, v in svc.metrics.snapshot()["counters"].items()
            if k.startswith(prefix)}


def run_si_section(args, svc=None, streams=None, sides=None) -> dict:
    """The SI leg (the JAX leg's `_run_si_section`) on ONE warm SI service.

    * WARM opens a session a bucket, then each timed request is a
      `decode_si` alone; PER-REQUEST-PREP pays `open_session` + `decode_si`
      + `close_session` a request. `--si_requests` a pass over --shapes in
      turn, `--si_repeats` pairs of passes in alternating order; `speedup`
      is the median of the pairs' throughput ratios (warm over
      per-request prep). The host's free cores are probed before and after
      every pair.
    * CHURN opens SI_CHURN_OPENS sessions, the buckets in turn, and after
      each open decodes through the newest SI_CHURN_WINDOW: every decode
      resolves ok or with a typed SessionError, and the store evicts
      (`evictions_by_reason`: "lru" past `session_max`, "bytes" past
      `session_max_bytes`).

    `steady_builds` counts the native builds over the whole leg (the JAX
    leg's `steady_compiles`); `modes_bit_equal` says whether the first
    pair's first image is the same in both modes; `warm_session_bytes` is
    the most the store held with a warm pass's sessions open.

    By default the leg builds and drains its own service (thread backend,
    SI on, `session_max` SI_SESSION_MAX) and draws its traffic from
    `args.seed + 3`. A caller may pass its own started, warm SI service and
    traffic (`streams`, `sides`: see `_leg_traffic`) and drain it itself."""
    own = svc is None
    warm = None
    if own:
        svc, warm = _build_service(args, enable_si=True,
                                   session_max=SI_SESSION_MAX)
    n = args.si_requests
    results = {mode: {"runs_rps": [], "lat_ms": [], "failed": 0}
               for mode in ("warm", "per_request_prep")}
    cores_before, cores_after, first = [], [], {}
    held = []
    try:
        builds = native_build.build_count()
        shapes, _, buckets, sides, streams = _leg_traffic(
            args, svc, 3, streams=streams, sides=sides)

        def timed_pass(decode):
            lat, failed, img0 = [], 0, None
            t0 = time.monotonic()
            for i in range(n):
                stream, bucket = streams[shapes[i % len(shapes)]]
                t1 = time.monotonic()
                try:
                    img = decode(stream, bucket)
                    if i == 0:
                        img0 = img
                except Exception:  # noqa: BLE001 — counted, gated
                    failed += 1
                lat.append((time.monotonic() - t1) * 1e3)
            dur = time.monotonic() - t0
            return n / dur if dur > 0 else 0.0, lat, failed, img0

        def warm_pass():
            sids = {b: svc.open_session(sides[b]) for b in buckets}
            held.append(svc.metrics.gauge("serve_session_bytes").value)
            out = timed_pass(lambda stream, bucket: svc.decode_si(
                stream, sids[bucket], timeout=600.0))
            for sid in sids.values():
                svc.close_session(sid)
            return out

        def perreq(stream, bucket):
            sid = svc.open_session(sides[bucket])
            img = svc.decode_si(stream, sid, timeout=600.0)
            svc.close_session(sid)
            return img

        for r in range(args.si_repeats):
            cores_before.append(round(_effective_cores(), 2))
            order = [("warm", warm_pass),
                     ("per_request_prep", lambda: timed_pass(perreq))]
            if r % 2:
                order.reverse()
            for mode, fn in order:
                rps, lat, failed, img0 = fn()
                results[mode]["runs_rps"].append(round(rps, 3))
                results[mode]["lat_ms"].extend(lat)
                results[mode]["failed"] += failed
                if r == 0:
                    first[mode] = img0
            cores_after.append(round(_effective_cores(), 2))

        # churn: sessions created and evicted under load
        evictions = svc.metrics.counter("serve_session_evictions")
        ev0, reasons0 = evictions.value, _eviction_counts(svc)
        sids = []
        ok = expired = untyped = 0
        for k in range(SI_CHURN_OPENS):
            bucket = buckets[k % len(buckets)]
            sids.append((bucket, svc.open_session(sides[bucket])))
            for b, sid in sids[-SI_CHURN_WINDOW:]:
                stream = next(s for s, bk in streams.values() if bk == b)
                try:
                    svc.decode_si(stream, sid, timeout=600.0)
                    ok += 1
                except SessionError:
                    expired += 1      # evicted underneath us: typed
                except Exception:  # noqa: BLE001 — the violation class
                    untyped += 1
        reasons = _eviction_counts(svc)
        churn = {
            "opened": len(sids), "decodes_ok": ok, "expired_typed": expired,
            "untyped": untyped, "evictions": evictions.value - ev0,
            "evictions_by_reason": {
                why: v - reasons0.get(why, 0) for why, v in reasons.items()
                if v != reasons0.get(why, 0)}}
        snap = svc.metrics.snapshot()
        steady_builds = native_build.build_count() - builds
    finally:
        if own:
            svc.drain(timeout=600.0)
    ratios = [w / p for w, p in zip(results["warm"]["runs_rps"],
                                    results["per_request_prep"]["runs_rps"])
              if p > 0]
    a, b = first.get("warm"), first.get("per_request_prep")

    def mode_entry(mode):
        res = results[mode]
        return {"throughput_rps": _median(res["runs_rps"]),
                "runs_rps": res["runs_rps"],
                "latency_ms": _lat_stats(res["lat_ms"]),
                "failed": res["failed"]}

    def hist(name):
        return {k: round(float(v), 3)
                for k, v in snap["histograms"].get(name, {}).items()}

    return {
        "requests_per_mode": n,
        "repeats": args.si_repeats,
        "session_max": svc.config.session_max,
        "session_max_bytes": svc.config.session_max_bytes,
        "warm_session_bytes": max(held, default=0),
        "warm": mode_entry("warm"),
        "per_request_prep": mode_entry("per_request_prep"),
        "pair_speedups": [round(r, 3) for r in ratios],
        "speedup": round(_median(ratios), 3) if ratios else None,
        "pair_effective_cores": cores_before,
        "pair_effective_cores_after": cores_after,
        "modes_bit_equal": bool(a is not None and b is not None
                                and np.array_equal(a, b)),
        "churn": churn,
        "prep_ms": hist("serve_si_prep_ms"),
        "search_ms": hist("serve_si_search_ms"),
        "sessions_opened": snap["counters"].get("serve_sessions_opened", 0),
        "steady_builds": steady_builds,
        "warmup": _rounded(warm),
    }


def gate_si(section, smoke: bool = True) -> list:
    """Violations of the SI leg (the JAX leg's `_gate_si`, builds for
    compiles): a failed request in either mode, a native build while
    sessions churned, a churn that never evicted or met an untyped error;
    under `smoke` also the warm speedup below SI_FLOOR, a note instead
    (stderr) where any of the pairs' free-core probes, before or after
    each pair, read below 1.3 (a serial window: the JAX gate reads the
    median of one probe a pair)."""
    violations = []
    for mode in ("warm", "per_request_prep"):
        if section[mode]["failed"]:
            violations.append(f"si {mode}: {section[mode]['failed']} "
                              f"requests failed")
    if section["steady_builds"]:
        violations.append(
            f"si: {section['steady_builds']} native builds while sessions "
            f"churned — session create/evict must reuse the warmed "
            f"kernels")
    churn = section["churn"]
    if churn.get("evictions", 0) <= 0:
        violations.append("si churn never evicted a session (vacuous — "
                          "the LRU bound did not engage)")
    if churn.get("untyped", 0):
        violations.append(f"si churn: {churn['untyped']} untyped "
                          f"errors (expiry must be SessionExpired)")
    if not smoke:
        return violations
    speedup = section.get("speedup")
    if speedup is None or speedup < SI_FLOOR:
        cores = section.get("pair_effective_cores") or []
        window = _pair_cores(section)
        if window is not None and window < 1.3:
            print(f"SERVE_BENCH_NOTE: warm-session speedup {speedup} "
                  f"below the {SI_FLOOR} floor in a serial window (effective "
                  f"cores before each pair {cores}, after "
                  f"{section.get('pair_effective_cores_after')}) — floor "
                  f"not applied", file=sys.stderr)
        else:
            violations.append(
                f"warm-session SI decode only {speedup}x the "
                f"per-request-prep baseline (floor {SI_FLOOR}; pairs "
                f"{section.get('pair_speedups')}, cores {cores}) — "
                f"the session cache is not amortizing the prep")
    return violations


def run_trace_section(args, svc=None, images=None, streams=None,
                      sides=None) -> dict:
    """The tracing leg (the JAX leg's `_run_trace_section`) on ONE warm SI
    service.

    * OVERHEAD: one mixed pass (`--trace_requests`, encode / decode /
      decode_si in turn over --shapes) in `--trace_repeats` pairs of a
      traced pass (sample rate 1.0, the flight recorder on) and an
      untraced one (tracer and recorder off), in alternating order;
      `overhead` is 1 - the median of the pairs' throughput ratios. The
      host's free cores are probed before and after every pair.
    * CROSS-CHECK: over the traced passes, the spans' summed ms per stage
      (`Tracer.stage_totals_ms`: one span a batch) against the metric
      layer over the same windows: the `serve_device_ms_total` and
      `serve_entropy_ms_total` accumulators and the `serve_si_search_ms`
      histogram (mean x count).
    * ARTIFACTS: one sampled decode_si trace read back over the service's
      `/trace` endpoint (its span names), an encode submitted past its
      deadline (a typed DeadlineExceeded) and the flight dump it triggers,
      the Chrome trace's event count.

    `steady_builds` counts the native builds over the whole leg (the JAX
    leg's `steady_compiles`). By default the leg builds and drains its own
    service (thread backend, SI on, metrics on an ephemeral port, a
    TRACE_CAPACITY span ring, unthrottled flight dumps to a temporary
    directory) and draws its traffic from `args.seed + 5`. A caller may
    pass its own started, warm SI service so configured (its sample rate
    is set to 1.0 here) and traffic (`images`, `streams`, `sides`: see
    `_leg_traffic`) and drain it itself."""
    own = svc is None
    warm = None
    if own:
        svc, warm = _build_service(
            args, enable_si=True, trace_sample_rate=1.0,
            trace_capacity=TRACE_CAPACITY,
            flight_dir=tempfile.mkdtemp(prefix="serve_trace_flight_"),
            flight_dump_min_interval_s=0.0, metrics_port=0)
    svc.tracer.set_sample_rate(1.0)
    n = args.trace_requests
    runs = {"traced": [], "untraced": []}
    cores_before, cores_after = [], []
    cross = {"device": [0.0, 0.0], "entropy": [0.0, 0.0],
             "si_search": [0.0, 0.0]}   # [span_ms, metric_ms] deltas
    span_key = {"device": trace_lib.SPAN_DEVICE,
                "entropy": trace_lib.SPAN_ENTROPY,
                "si_search": trace_lib.SPAN_SI_SEARCH}
    try:
        builds = native_build.build_count()
        shapes, images, buckets, sides, streams = _leg_traffic(
            args, svc, 5, images=images, streams=streams, sides=sides)
        sids = {b: svc.open_session(sides[b]) for b in buckets}

        def one_pass():
            t0 = time.monotonic()
            for i in range(n):
                stream, bucket = streams[shapes[i % len(shapes)]]
                if i % 3 == 0:
                    svc.encode(images[i % len(images)], timeout=600.0)
                elif i % 3 == 1:
                    svc.decode(stream, timeout=600.0)
                else:
                    svc.decode_si(stream, sids[bucket], timeout=600.0)
            _quiesce(svc)
            dur = time.monotonic() - t0
            return n / dur if dur > 0 else 0.0

        def metric_totals():
            snap = svc.metrics.snapshot()
            si = snap["histograms"].get("serve_si_search_ms",
                                        {"count": 0, "mean": 0.0})
            acc = snap["accumulators"]
            return {"device": acc.get("serve_device_ms_total", 0.0),
                    "entropy": acc.get("serve_entropy_ms_total", 0.0),
                    "si_search": si["mean"] * si["count"]}

        for r in range(args.trace_repeats):
            cores_before.append(round(_effective_cores(), 2))
            order = ["traced", "untraced"] if r % 2 == 0 \
                else ["untraced", "traced"]
            for mode in order:
                traced = mode == "traced"
                svc.tracer.set_enabled(traced)
                svc.flight.set_enabled(traced)
                if traced:
                    svc.tracer.reset()
                    m0 = metric_totals()
                    rps = one_pass()
                    m1 = metric_totals()
                    spans = svc.tracer.stage_totals_ms()
                    for k in cross:
                        cross[k][0] += spans.get(span_key[k], 0.0)
                        cross[k][1] += m1[k] - m0[k]
                else:
                    rps = one_pass()
                runs[mode].append(round(rps, 3))
            cores_after.append(round(_effective_cores(), 2))
        svc.tracer.set_enabled(True)
        svc.flight.set_enabled(True)

        # one sampled decode_si trace, read back over the /trace endpoint
        bucket = buckets[0]
        stream = next(s for s, bk in streams.values() if bk == bucket)
        fut = svc.submit_decode_si(stream, sids[bucket])
        fut.result(timeout=600.0)
        tid = fut.trace.trace_id
        _quiesce(svc)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{svc.metrics_port}/trace?id={tid}",
                timeout=10) as resp:
            body = json.loads(resp.read().decode("utf-8"))
        sample_trace = {
            "trace_id": tid,
            "span_names": sorted({s["name"] for s in body["spans"]}),
            "spans": len(body["spans"])}

        # a typed error (the deadline passed at submit) triggers a dump
        f = svc.submit_encode(images[0], deadline_ms=0.0001)
        try:
            f.result(timeout=30)
        except Exception:  # noqa: BLE001 — the typed error IS the point
            pass
        svc.flight.flush(timeout=10)
        steady_builds = native_build.build_count() - builds
        flight_meta = svc.flight.meta()
        chrome_events = svc.tracer.dump_chrome(
            os.path.join(svc.flight.dump_dir, "trace_chrome.json"))
    finally:
        if own:
            svc.drain(timeout=600.0)
    ratios = [t / u for t, u in zip(runs["traced"], runs["untraced"])
              if u > 0]
    return {
        "requests_per_pass": n,
        "repeats": args.trace_repeats,
        "traced_rps": _median(runs["traced"]),
        "untraced_rps": _median(runs["untraced"]),
        "runs": runs,
        "pair_ratios": [round(r, 4) for r in ratios],
        "pair_effective_cores": cores_before,
        "pair_effective_cores_after": cores_after,
        "overhead": round(1.0 - _median(ratios), 4) if ratios else None,
        "cross_check": {k: {"span_ms": round(span_ms, 3),
                            "metric_ms": round(metric_ms, 3),
                            "drift_ms": round(abs(span_ms - metric_ms), 3)}
                        for k, (span_ms, metric_ms) in cross.items()},
        "sample_trace": sample_trace,
        "flight": {"dumps": flight_meta["dumps"],
                   "events": flight_meta["events"],
                   "last_dump_path": flight_meta["last_dump_path"]},
        "chrome_events": chrome_events,
        "steady_builds": steady_builds,
        "warmup": _rounded(warm),
    }


def gate_trace(section, smoke: bool = True) -> list:
    """Violations of the tracing leg (the JAX leg's `_gate_trace`, builds
    for compiles): a native build with tracing on, a stage whose spans and
    metrics drift apart by more than max(10%, 5 ms), a sampled decode_si
    trace without the five span names (SI_TRACE_SPANS), no flight dump;
    under `smoke` also the overhead: above TRACE_BROKEN always, above
    TRACE_BUDGET unless the pair ratios spread wider than 0.05 (the
    JAX gate's noise escape) or any of the pairs' free-core probes, before
    or after each pair, read below 1.3 (a serial window; the JAX gate has
    no such escape): a note instead (stderr)."""
    violations = []
    if section["steady_builds"]:
        violations.append(
            f"tracing leg: {section['steady_builds']} native builds with "
            f"tracing enabled — spans leaked into the dataplane")
    for stage, c in section["cross_check"].items():
        slack = max(0.10 * max(c["metric_ms"], c["span_ms"]), 5.0)
        if c["drift_ms"] > slack:
            violations.append(
                f"trace cross-check: {stage} spans sum {c['span_ms']}ms "
                f"but the metric layer recorded {c['metric_ms']}ms "
                f"(drift {c['drift_ms']}ms > slack {round(slack, 1)}ms) "
                f"— the two instrumentation layers disagree")
    names = set(section["sample_trace"].get("span_names", ()))
    missing = set(SI_TRACE_SPANS) - names
    if missing:
        violations.append(
            f"sample decode_si trace is missing spans {sorted(missing)} "
            f"(got {sorted(names)})")
    if not section["flight"]["dumps"] or \
            not section["flight"]["last_dump_path"]:
        violations.append("typed error did not produce a flight-"
                          "recorder dump")
    if not smoke:
        return violations
    overhead = section.get("overhead")
    pairs = section.get("pair_ratios") or []
    if overhead is None or overhead > TRACE_BROKEN:
        violations.append(
            f"tracing overhead {overhead} in the broken band (>25%): "
            f"pairs {pairs}")
    elif overhead > TRACE_BUDGET:
        spread = (max(pairs) - min(pairs)) if pairs else 0.0
        window = _pair_cores(section)
        if spread > 0.05:
            print(f"SERVE_BENCH_NOTE: tracing overhead {overhead} over "
                  f"the {TRACE_BUDGET} budget but pair ratios spread "
                  f"{round(spread, 3)} — measurement noise exceeds the "
                  f"gate's resolution this window", file=sys.stderr)
        elif window is not None and window < 1.3:
            print(f"SERVE_BENCH_NOTE: tracing overhead {overhead} over "
                  f"the {TRACE_BUDGET} budget in a serial window "
                  f"(effective cores {window}) — budget not applied",
                  file=sys.stderr)
        else:
            violations.append(
                f"tracing overhead {overhead} exceeds the "
                f"{TRACE_BUDGET} budget with stable pairs {pairs}")
    return violations


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
        # populate at gap rate 1.0: the first encode of every shape, so
        # every served bucket's gap histogram gets a sample. A pass's
        # encodes cycle only the first images at the default
        # --quality_requests, and a bucket left to the prober's probes
        # had its sample only when a probe landed in this window (under a
        # loaded host, 1 leg in 4 had none)
        prev = svc.quality.set_gap_sample_rate(1.0)
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
    p = argparse.ArgumentParser(description="the port's serve bench: one "
                                "or more of its legs")
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
    p.add_argument("--si_only", action="store_true",
                   help="run the SI leg (warm sessions against per-request "
                        "prep, then session churn)")
    p.add_argument("--si_requests", type=int, default=48,
                   help="decode_si requests a pass of each SI mode")
    p.add_argument("--si_repeats", type=int, default=3,
                   help="warm / per-request-prep pass pairs; the speedup "
                        "is the median pair ratio")
    p.add_argument("--trace", dest="trace_only", action="store_true",
                   help="run the tracing leg (traced against untraced "
                        "passes, the span-vs-metric cross-check, a /trace "
                        "read-back and a flight dump)")
    p.add_argument("--trace_requests", type=int, default=24,
                   help="requests a pass of the tracing leg's mixed stream")
    p.add_argument("--trace_repeats", type=int, default=3,
                   help="traced / untraced pass pairs; the overhead is 1 - "
                        "the median pair ratio")
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
    p.add_argument("--devices", default=None,
                   help="space-separated logical device counts of the "
                        "device axis, e.g. '1 2 4 8' (default with "
                        "--devices_only: '1 2 4 8', '1 2' under --smoke)")
    p.add_argument("--devices_only", action="store_true",
                   help="run the device axis alone")
    p.add_argument("--smoke", action="store_true",
                   help="the chaos bench's tiny configuration, 32x48 "
                        "buckets and a few requests: seconds of CPU")
    args = p.parse_args(argv)
    others = (args.precision or args.entropy_backend or args.transport
              or args.quality or args.frontdoor_only or args.autoscale_only
              or args.federation_only)
    si_legs = args.si_only or args.trace_only
    if args.devices_only and others:
        p.error("--devices_only runs the device axis alone")
    if si_legs and (others or args.devices_only or args.devices):
        p.error("--si_only and --trace run without the other legs")
    if args.devices is None and args.devices_only:
        args.devices = "1 2" if args.smoke else "1 2 4 8"
    axis = [int(v) for v in (args.devices or "").split()]
    if any(n < 1 for n in axis):
        p.error(f"bad --devices axis {axis}")
    if not (others or axis or si_legs):
        p.error("choose a leg: --precision, --entropy_backend both, "
                "--transport both, --quality, --frontdoor_only, "
                "--autoscale, --federation_only, --devices_only, --si_only "
                "or --trace")
    resolve_device(args.device)
    if args.smoke:
        from dsin_tpu_torch.tools.chaos_bench import write_smoke_cfgs
        args.ae_config, args.pc_config = write_smoke_cfgs(tempfile.mkdtemp())
        args.buckets, args.shapes = "32,48", "32,48 24,32"
        args.requests, args.rate = 12, 200.0
        args.frontdoor_requests, args.frontdoor_rate = 24, 200.0
        args.entropy_workers = 1
        if si_legs:
            # the JAX smoke's own shapes, buckets and request counts
            args.buckets, args.shapes = "48,96 64,96", "32,48 48,96 64,96"
            args.si_requests, args.trace_requests = 20, 18
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
    if axis:
        report["config"].update(
            buckets=args.buckets, shapes=args.shapes, smoke=args.smoke,
            requests=args.requests, rate=args.rate, devices_axis=axis,
            entropy_workers=args.entropy_workers,
            pipeline_depth=LEG_PIPELINE_DEPTH, max_batch=LEG_MAX_BATCH)
        report["devices"] = run_device_axis(args, axis)
        violations += gate_device_axis(report["devices"], smoke=args.smoke)
    if si_legs:
        report["config"].update(
            buckets=args.buckets, shapes=args.shapes, smoke=args.smoke,
            si_requests=args.si_requests, si_repeats=args.si_repeats,
            trace_requests=args.trace_requests,
            trace_repeats=args.trace_repeats, max_batch=LEG_MAX_BATCH,
            max_wait_ms=args.max_wait_ms,
            entropy_workers=args.entropy_workers)
    if args.si_only:
        report["si"] = run_si_section(args)
        violations += gate_si(report["si"], smoke=args.smoke)
    if args.trace_only:
        report["trace"] = run_trace_section(args)
        violations += gate_trace(report["trace"], smoke=args.smoke)
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
