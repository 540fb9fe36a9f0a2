"""Two batteries of the chaos bench (counterparts of the JAX package's
`tools/chaos_bench.py` `run_hotswap` :407 and `run_degraded` :1158): the
live model operations and the degraded model, each against one running
`CompressionService`.

    python -m dsin_tpu_torch.tools.chaos_bench --smoke --hotswap_only \\
        --device cpu --out /tmp/h.json
    python -m dsin_tpu_torch.tools.chaos_bench --smoke --degraded_only \\
        --device cpu --out /tmp/d.json

Hot-swap battery (`--hotswap_only`): a second model (another seed) is
saved with a full manifest, then adopted by the running service through
`swap_model` under four scenarios: a kill injected in the PREPARE window
(the `serve.swap` fault site), a kill in the COMMIT window, a corrupted
incoming `manifest.json` (the `ckpt.manifest` site: the swap must refuse
typed), and a clean swap UNDER LOAD followed by an instant `rollback()`;
then the post-commit watchdog must roll a typed-error storm back by itself.
Invariants: no hung future, no WRONG-DIGEST response (every encode during
the swap is byte-equal to the old model's stream or the new model's for
that image: no torn batch), the old model's bytes after every abort, and
no native build (`native_build.build_count()`) across any of it.

Degraded-model battery (`--degraded_only`): (1) a session opened on an
UNCORRELATED side image trips the SI-match floor alarm (where the search
returns scores: on the CPU; on the card K2 folds them and the scenario is
recorded as not applicable); (2) the canary publish flow (prepare the
candidate, record its goldens, abort, re-save) and its teeth: a
BIT-FLIPPED twin carrying the good model's goldens verifies against its own
manifest but is REFUSED typed `CanaryFailed` at prepare, the old model
serving on bit for bit; (3) the same twin force-committed (`canary=False`)
is caught by the background prober, which arms the watchdog: the service
rolls back to the good model by itself. Invariants: no hung future, every
failure typed, a non-empty flight dump, no native build.

Every other battery of the JAX bench is refused with an error that names
ROADMAP Queue 1 item 11g. `--smoke` serves the tiny configuration (the
JAX bench's smoke configs) at seconds of CPU; without it the AE and PC
configs are `--ae_config` / `--pc_config`. Like every entry point of the
port it runs on the card unless `--device cpu` is given. Exits 1 on any
violation; the report goes to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

from dsin_tpu_torch import native_build
from dsin_tpu_torch.coding.loader import tree_leaves
from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.runtime import config_path, resolve_device
from dsin_tpu_torch.serve import (CanaryFailed, CompressionService,
                                  ServeError, ServiceConfig)
from dsin_tpu_torch.train import checkpoint as ckpt_lib
from dsin_tpu_torch.utils import faults

ROADMAP_CHAOS = ("ROADMAP Queue 1 item 11g (the rest of the chaos bench: "
                 "the main soak, sessions, autoscale, transport and "
                 "federation batteries)")

#: the JAX bench's smoke configuration (its tools/serve_bench.py)
SMOKE_AE_CFG = """
arch = CVPR
arch_param_B = 1
num_chan_bn = 4
heatmap = True
num_centers = 6
centers_initial_range = (-2, 2)
normalization = 'FIXED'
AE_only = True
si_weight = 0.7
y_patch_size = (8, 12)
use_gauss_mask = True
use_L2andLAB = False
batch_size = 1
num_crops_per_img = 1
H_target = 0.08
beta = 500
distortion_to_minimize = 'mae'
K_psnr = 100
K_ms_ssim = 5000
regularization_factor = 0.0005
regularization_factor_centers = 0.01
optimizer = 'ADAM'
lr_initial = 3e-4
lr_schedule = 'FIXED'
train_autoencoder = True
train_probclass = True
lr_centers_factor = None
bn_stats = 'update'
"""

SMOKE_PC_CFG = """
arch = res_shallow
kernel_size = 3
arch_param__k = 6
use_centers_for_padding = True
regularization_factor = None
optimizer = 'ADAM'
lr_initial = 3e-4
lr_schedule = 'FIXED'
"""


def write_smoke_cfgs(tmpdir: str):
    """The smoke AE and PC configs written into `tmpdir` -> their paths."""
    ae_p = os.path.join(tmpdir, "ae_smoke")
    pc_p = os.path.join(tmpdir, "pc_smoke")
    with open(ae_p, "w") as f:
        f.write(SMOKE_AE_CFG)
    with open(pc_p, "w") as f:
        f.write(SMOKE_PC_CFG)
    return ae_p, pc_p


def parse_shapes(spec: str):
    return [tuple(int(v) for v in part.split(",")) for part in spec.split()]


def classify(exc) -> str:
    """-> 'ok' | 'typed' | 'untyped' for a resolved future's exception."""
    if exc is None:
        return "ok"
    # ValueError covers IntegrityError and the stream-framing errors
    if isinstance(exc, (ServeError, ValueError, faults.InjectedFault,
                        faults.InjectedCrash)):
        return "typed"
    return "untyped"


def await_all(futures, timeout_s: float):
    """Resolve every future -> (counts by class, hung count)."""
    counts = {"ok": 0, "typed": 0, "untyped": 0}
    hung = 0
    deadline = time.monotonic() + timeout_s
    for f in futures:
        try:
            exc = f.exception(timeout=max(0.0, deadline - time.monotonic()))
        except TimeoutError:
            hung += 1
            continue
        counts[classify(exc)] += 1
    return counts, hung


def bitflip_params(state: ckpt_lib.ModelState) -> ckpt_lib.ModelState:
    """Flip mantissa bit 22 of the first 16 values of the first params leaf
    in JAX's leaf order (the JAX bench's `_bitflip_params`): damage that is
    corrupted but self-consistent, so a checkpoint re-saved from it
    verifies against its own manifest and only the canary stands in its
    way."""
    leaf = tree_leaves(state.params)[0]

    def flipped(tree):
        if isinstance(tree, dict):
            return {k: flipped(v) for k, v in tree.items()}
        if tree is not leaf:
            return tree
        arr = np.array(tree, np.float32)
        flat = arr.reshape(-1)
        n = min(16, flat.size)
        view = flat[:n].copy().view(np.uint32)
        view ^= np.uint32(1 << 22)
        flat[:n] = view.view(np.float32)
        return arr

    return state._replace(params=flipped(state.params))


def model_state(args, seed: int, need_sinet: bool):
    """The seeded model of the configs as a ModelState, and the manifest
    identity the service verifies (pc-config hash, seed; no ladder)."""
    ae = parse_config_file(args.ae_config).replace(AE_only=not need_sinet)
    pc = parse_config_file(args.pc_config)
    model = build_model(ae, pc, device="cpu", seed=seed)
    return (ckpt_lib.state_from_model(model),
            {"pc_config_sha256": ckpt_lib.config_sha256(pc), "seed": seed})


def service_config(args, buckets, **over) -> ServiceConfig:
    kw = dict(ae_config=args.ae_config, pc_config=args.pc_config,
              seed=args.seed, buckets=buckets, max_batch=args.max_batch,
              max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
              workers=args.workers, entropy_workers=args.entropy_workers,
              entropy_backend=args.entropy_backend,
              pipeline_depth=args.pipeline_depth,
              rollback_watchdog_window_s=0.3,
              rollback_watchdog_threshold=0.3,
              rollback_watchdog_min_requests=3,
              trace_sample_rate=1.0, flight_dump_min_interval_s=0.0,
              device=args.device)
    kw.update(over)
    return ServiceConfig(**kw)


def run_hotswap(args) -> dict:
    """The live-model-operations battery (see the module docstring)."""
    shapes = parse_shapes(args.shapes)
    buckets = parse_shapes(args.buckets)
    service = CompressionService(service_config(
        args, buckets,
        flight_dir=tempfile.mkdtemp(prefix="chaos_swap_flight_"))).start()
    warm = service.warmup()
    rng = np.random.default_rng(args.seed + 7)
    images = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
              for h, w in shapes]
    violations, scenarios = [], {}
    t0 = time.monotonic()
    state_b, extra = model_state(args, args.seed + 1, need_sinet=False)
    ckpt_b = os.path.join(tempfile.mkdtemp(prefix="chaos_hotswap_"),
                          "ckpt_b")
    ckpt_lib.save_checkpoint(ckpt_b, state_b, manifest_extra={
        **extra, "buckets": [list(b) for b in buckets]})
    digest_a = service.model_digest
    builds = native_build.build_count()
    a_streams = [service.encode(img, timeout=args.timeout_s).stream
                 for img in images]

    def still_old(tag):
        """After an abort the service serves the OLD model, bit for bit,
        with the swap machinery idle."""
        if service.model_digest != digest_a:
            violations.append(f"{tag}: the digest moved off the old model")
        snap = service.health()["model"]
        if snap["swap_state"] != 0 or snap["staged_digest"]:
            violations.append(f"{tag}: swap not idle after abort: {snap}")
        if service.encode(images[0], timeout=args.timeout_s).stream \
                != a_streams[0]:
            violations.append(f"{tag}: the old model's stream changed")

    for tag, after in (("kill_prepare", 0), ("kill_commit", 1)):
        plan = faults.FaultPlan([faults.FaultSpec(
            site="serve.swap", action="crash", after=after, times=1)],
            seed=args.seed)
        killed = False
        with faults.installed(plan):
            try:
                service.swap_model(ckpt_b)
            except faults.InjectedCrash:
                killed = True
        if not killed:
            violations.append(f"{tag}: the injected crash never fired")
        still_old(tag)
        scenarios[tag] = {"killed": killed, "serving_old_params": True}

    plan = faults.FaultPlan([faults.FaultSpec(
        site="ckpt.manifest", action="corrupt", flips=64, times=1)],
        seed=args.seed)
    detected = False
    with faults.installed(plan):
        try:
            service.swap_model(ckpt_b)
        except ValueError:
            # IntegrityError (unparseable) or ManifestMismatch (parsed but
            # lying): both typed refusals
            detected = True
    if not detected:
        violations.append("corrupt_manifest: a corrupted manifest was "
                          "adopted")
    still_old("corrupt_manifest")
    scenarios["corrupt_manifest"] = {"detected": detected}

    # -- a clean swap UNDER LOAD, every response audited ----------------------
    futures, door_rejects, stop, swapped = [], 0, threading.Event(), {}

    def swapper():
        try:
            swapped["info"] = service.swap_model(ckpt_b)
        finally:
            stop.set()

    thread = threading.Thread(target=swapper, name="chaos-swapper")
    thread.start()
    i = 0
    while not stop.is_set() and i < 100000:
        try:
            futures.append((i % len(images), service.submit_encode(
                images[i % len(images)])))
        except ServeError:
            door_rejects += 1
        i += 1
        time.sleep(args.submit_gap_s)
    thread.join(timeout=args.timeout_s)
    digest_b = swapped.get("info", {}).get("digest")
    if thread.is_alive() or digest_b is None:
        violations.append("swap_under_load: swap_model did not complete")
    counts, hung = await_all([f for _, f in futures], args.timeout_s)
    b_streams = [service.encode(img, timeout=args.timeout_s).stream
                 for img in images]
    results = [(idx, f.result(0)) for idx, f in futures
               if f.done() and f.exception(0) is None]
    results += [(k % len(images), service.encode(
        images[k % len(images)], timeout=args.timeout_s))
        for k in range(2 * len(images))]
    old = new = wrong = 0
    for idx, res in results:
        if res.model_digest == digest_a and res.stream == a_streams[idx]:
            old += 1
        elif res.model_digest == digest_b and res.stream == b_streams[idx]:
            new += 1
        else:
            wrong += 1
    if hung:
        violations.append(f"swap_under_load: {hung} hung futures")
    if counts["untyped"]:
        violations.append(f"swap_under_load: {counts['untyped']} untyped "
                          f"errors")
    if wrong:
        violations.append(f"swap_under_load: {wrong} WRONG-DIGEST "
                          f"responses (torn batches)")
    if new == 0:
        violations.append("swap_under_load: no response came from the new "
                          "model")
    scenarios["swap_under_load"] = {
        "submitted": len(futures), "door_rejects": door_rejects,
        "old_model_responses": old, "new_model_responses": new,
        "typed_errors": counts["typed"], "untyped_errors": counts["untyped"],
        "hung_futures": hung, "wrong_digest_responses": wrong,
        "digest_a": digest_a, "digest_b": digest_b}

    service.rollback()
    roll = service.encode(images[0], timeout=args.timeout_s)
    if roll.stream != a_streams[0] or roll.model_digest != digest_a:
        violations.append("rollback: the old model's bytes are lost")
    scenarios["rollback"] = {
        "digest": service.model_digest,
        "bit_identical_to_pre_swap": roll.stream == a_streams[0]}

    # -- the watchdog rolls a post-swap typed-error storm back ----------------
    wd_before = service.metrics.counter("serve_watchdog_rollbacks").value
    service.swap_model(ckpt_b)
    b_stream = service.encode(images[0], timeout=args.timeout_s).stream
    bad_plan = faults.FaultPlan([faults.FaultSpec(
        site="serve.rans", action="corrupt", probability=1.0)],
        seed=args.seed + 3)
    wd_typed = wd_other = 0
    fired = False
    with faults.installed(bad_plan):
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            exc = service.submit_decode(b_stream).exception(
                timeout=args.timeout_s)
            if isinstance(exc, Exception):
                wd_typed += 1
            else:
                wd_other += 1
            if service.model_digest == digest_a:
                fired = True
                break
            time.sleep(0.02)
    wd_rollbacks = service.metrics.counter(
        "serve_watchdog_rollbacks").value - wd_before
    if not fired or wd_rollbacks < 1:
        violations.append(f"watchdog_rollback: the typed-error storm was "
                          f"not rolled back ({wd_rollbacks} watchdog "
                          f"rollbacks, serving {service.model_digest})")
    clean = service.encode(images[0], timeout=args.timeout_s)
    if clean.stream != a_streams[0]:
        violations.append("watchdog_rollback: the old model's bytes are "
                          "lost after the rollback")
    scenarios["watchdog_rollback"] = {
        "fired": fired, "watchdog_rollbacks": wd_rollbacks,
        "typed_errors_during": wd_typed, "untyped_during": wd_other,
        "digest_after": service.model_digest,
        "bit_identical_after": clean.stream == a_streams[0]}
    steady_builds = native_build.build_count() - builds
    if steady_builds:
        violations.append(f"{steady_builds} native builds across swap and "
                          f"rollback")
    counters = service.metrics.snapshot()["counters"]
    service.drain()
    return {"warmup": warm, "scenarios": scenarios,
            "swap_counters": {k: v for k, v in counters.items()
                              if "swap" in k or "rollback" in k},
            "steady_builds": steady_builds,
            "duration_s": round(time.monotonic() - t0, 3),
            "violations": violations}


def run_degraded(args) -> dict:
    """The degraded-model battery (see the module docstring)."""
    buckets = [(16, 24), (32, 48)] if args.smoke else \
        parse_shapes(args.buckets)
    service = CompressionService(service_config(
        args, buckets, enable_si=True, session_max=8, canary_every_s=0.15,
        quality_gap_sample_rate=1.0, si_alarm_min_samples=6,
        flight_dir=tempfile.mkdtemp(prefix="chaos_degraded_flight_"))
    ).start()
    warm = service.warmup()
    rng = np.random.default_rng(args.seed + 13)
    violations, scenarios = [], {}
    t0 = time.monotonic()
    builds = native_build.build_count()
    bucket = buckets[0]
    img = rng.integers(0, 255, (bucket[0], bucket[1], 3), dtype=np.uint8)
    a_stream = service.encode(img, timeout=args.timeout_s).stream
    digest_a = service.model_digest

    # -- (1) an uncorrelated side image trips the SI-match alarm --------------
    # the floor is calibrated: round 1 measures a correlated (y == x) and an
    # uncorrelated side, the floor lands at their midpoint, round 2 (fresh
    # sessions) must trip the alarm on the uncorrelated one
    noise = rng.integers(0, 255, (bucket[0], bucket[1], 3), dtype=np.uint8)
    if not service._si_scores_enabled:
        scenarios["si_match_alarm"] = {
            "applicable": False,
            "reason": f"the SI search runs on route {service._si_route!r}, "
                      f"which returns no scores"}
    else:
        cal_good, cal_bad = (service.open_session(img),
                             service.open_session(noise))
        futures = []
        for _ in range(4):
            futures.append(service.submit_decode_si(a_stream, cal_good))
            futures.append(service.submit_decode_si(a_stream, cal_bad))
        counts0, hung0 = await_all(futures, args.timeout_s)
        cal = service.quality.si_session_summaries()
        good_mean = cal.get(cal_good, {}).get("mean", 0.0)
        bad_mean = cal.get(cal_bad, {}).get("mean", 0.0)
        service.close_session(cal_good)
        service.close_session(cal_bad)
        separable = good_mean - bad_mean >= 0.05
        floor = round((good_mean + bad_mean) / 2.0, 4)
        if separable:
            service.quality.si_score_floor = floor
        sid_good, sid_bad = (service.open_session(img),
                             service.open_session(noise))
        futures = []
        for _ in range(8):
            futures.append(service.submit_decode_si(a_stream, sid_good))
            futures.append(service.submit_decode_si(a_stream, sid_bad))
        counts, hung = await_all(futures, args.timeout_s)
        summaries = service.quality.si_session_summaries()
        bad_sum = summaries.get(sid_bad, {})
        alarm_events = [e for e in service.flight.snapshot()
                        if e["kind"] == "quality_alarm"]
        if hung0 or hung:
            violations.append(f"si_match_alarm: {hung0 + hung} hung "
                              f"futures")
        if counts0["untyped"] or counts["untyped"]:
            violations.append("si_match_alarm: untyped errors")
        if separable and not bad_sum.get("alarmed"):
            violations.append(f"si_match_alarm: the uncorrelated side never "
                              f"tripped the calibrated floor {floor} "
                              f"({bad_sum})")
        if separable and not alarm_events:
            violations.append("si_match_alarm: no quality_alarm event")
        scenarios["si_match_alarm"] = {
            "applicable": True,
            "decodes_ok": counts0["ok"] + counts["ok"],
            "calibration": {"good_mean": round(good_mean, 4),
                            "bad_mean": round(bad_mean, 4),
                            "floor": floor, "separable": separable},
            "good_session": summaries.get(sid_good, {}),
            "bad_session": bad_sum,
            "alarm_transitions": service.metrics.counter(
                "serve_si_match_alarm_transitions").value,
            "alarm_events": len(alarm_events)}
        service.close_session(sid_good)
        service.close_session(sid_bad)

    # -- (2) the publish flow, and the bit-flipped twin refused ---------------
    state_b, extra = model_state(args, args.seed + 1, need_sinet=True)
    extra["buckets"] = [list(b) for b in buckets]
    tmpd = tempfile.mkdtemp(prefix="chaos_degraded_")
    ckpt_b = os.path.join(tmpd, "ckpt_b")
    ckpt_lib.save_checkpoint(ckpt_b, state_b, manifest_extra=extra)
    service.prepare_swap(ckpt_b)
    goldens = service.canary_goldens(staged=True)
    service.abort_swap()
    ckpt_lib.save_checkpoint(ckpt_b, state_b,
                             manifest_extra={**extra, "canary": goldens})
    info = service.swap_model(ckpt_b)
    clean_passed = info.get("canary", {}).get("status") == "passed"
    if not clean_passed:
        violations.append(f"degraded: the clean swap's canary did not pass: "
                          f"{info.get('canary')}")
    digest_b = info["digest"]
    service.rollback()
    ckpt_bad = os.path.join(tmpd, "ckpt_bad")
    ckpt_lib.save_checkpoint(ckpt_bad, bitflip_params(state_b),
                             manifest_extra={**extra, "canary": goldens})
    refused = False
    try:
        service.swap_model(ckpt_bad)
    except CanaryFailed:
        refused = True
    except Exception as e:  # noqa: BLE001 — a wrong type is a violation
        violations.append(f"degraded: the corrupted swap failed UNTYPED "
                          f"({type(e).__name__}: {e})")
    if not refused:
        violations.append("degraded: the canary did not refuse the "
                          "bit-flipped staged swap")
    if service.model_digest != digest_a or service.encode(
            img, timeout=args.timeout_s).stream != a_stream:
        violations.append("degraded: the good model's bytes are lost after "
                          "the refusal")
    scenarios["canary_refusal"] = {
        "clean_swap_canary_passed": clean_passed, "digest_a": digest_a,
        "digest_b": digest_b, "refused": refused,
        "swap_refusals": service.metrics.counter(
            "serve_canary_swap_refusals").value,
        "serving_old_params": service.model_digest == digest_a}

    # -- (3) forced commit: the prober arms the watchdog ----------------------
    wd_before = service.metrics.counter("serve_watchdog_rollbacks").value
    t_commit = time.monotonic()
    service.swap_model(ckpt_bad, canary=False)
    digest_bad = service.model_digest
    fired = False
    while time.monotonic() < t_commit + 60.0:
        if service.model_digest == digest_a:
            fired = True
            break
        time.sleep(0.02)
    rolled_s = time.monotonic() - t_commit
    wd_rollbacks = service.metrics.counter(
        "serve_watchdog_rollbacks").value - wd_before
    canary_failures = service.metrics.counter("serve_canary_failures").value
    if not fired or wd_rollbacks < 1:
        violations.append(f"degraded: the force-committed model was not "
                          f"rolled back ({wd_rollbacks} watchdog rollbacks, "
                          f"serving {service.model_digest})")
    if canary_failures < 1:
        violations.append("degraded: the prober never recorded a failure")
    post = service.encode(img, timeout=args.timeout_s)
    if post.stream != a_stream or post.model_digest != digest_a:
        violations.append("degraded: the good model's bytes are lost after "
                          "the watchdog's rollback")
    scenarios["forced_commit_watchdog"] = {
        "digest_bad": digest_bad, "fired": fired,
        "seconds_to_rollback": round(rolled_s, 3),
        "watchdog_rollbacks": wd_rollbacks,
        "canary_failures": canary_failures,
        "digest_after": service.model_digest,
        "bit_identical_after": post.stream == a_stream}
    steady_builds = native_build.build_count() - builds
    if steady_builds:
        violations.append(f"degraded battery: {steady_builds} native builds")
    service.flight.flush(timeout=10.0)
    meta = service.flight.meta()
    last_events = 0
    if meta["last_dump_path"]:
        with open(meta["last_dump_path"]) as f:
            last_events = sum(1 for _ in f) - 1
    if meta["dumps"] < 1 or last_events < 1:
        violations.append(f"degraded battery left no non-empty flight dump "
                          f"({meta['dumps']} dumps)")
    counters = service.metrics.snapshot()["counters"]
    service.drain()
    return {"warmup": warm, "scenarios": scenarios,
            "canary_counters": {k: v for k, v in counters.items()
                                if "canary" in k},
            "flight_recorder": {"dumps": meta["dumps"],
                                "last_dump_events": last_events},
            "steady_builds": steady_builds,
            "duration_s": round(time.monotonic() - t0, 3),
            "violations": violations}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the port's chaos bench: the "
                                "hot-swap and degraded-model batteries")
    p.add_argument("--ae_config", default=config_path("ae_kitti_stereo"))
    p.add_argument("--pc_config", default=config_path("pc_default"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shapes", default="16,24 24,32 32,48")
    p.add_argument("--buckets", default="24,32 32,48")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--entropy_workers", type=int, default=None)
    p.add_argument("--entropy_backend", default="thread",
                   choices=("thread", "process"))
    p.add_argument("--pipeline_depth", type=int, default=2)
    p.add_argument("--max_batch", type=int, default=2)
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--max_queue", type=int, default=64)
    p.add_argument("--submit_gap_s", type=float, default=0.002)
    p.add_argument("--timeout_s", type=float, default=60.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="CHAOS_BENCH_TORCH.json")
    p.add_argument("--smoke", action="store_true",
                   help="the tiny smoke configs, seconds of CPU")
    p.add_argument("--hotswap_only", action="store_true",
                   help="the live-model-operations battery")
    p.add_argument("--degraded_only", action="store_true",
                   help="the degraded-model battery")
    for name in ("sessions_only", "autoscale_only", "transport_only",
                 "federation_only"):
        p.add_argument(f"--{name}", action="store_true",
                       help=f"not ported: {ROADMAP_CHAOS}")
    args = p.parse_args(argv)
    for name in ("sessions_only", "autoscale_only", "transport_only",
                 "federation_only"):
        if getattr(args, name):
            p.error(f"--{name} is not ported to dsin_tpu_torch yet: "
                    f"{ROADMAP_CHAOS}")
    if not (args.hotswap_only or args.degraded_only):
        p.error(f"choose --hotswap_only or --degraded_only; the main soak "
                f"is not ported to dsin_tpu_torch yet: {ROADMAP_CHAOS}")
    resolve_device(args.device)
    if args.smoke:
        args.ae_config, args.pc_config = write_smoke_cfgs(tempfile.mkdtemp())
    report = {"config": {"smoke": args.smoke, "seed": args.seed,
                         "device": args.device}, "violations": []}
    if args.hotswap_only:
        report["hotswap"] = run_hotswap(args)
        report["violations"] += report["hotswap"]["violations"]
    if args.degraded_only:
        report["degraded_model"] = run_degraded(args)
        report["violations"] += report["degraded_model"]["violations"]
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, args.out)
    print(json.dumps({k: v for k, v in report.items() if k != "config"},
                     indent=1))
    if report["violations"]:
        print(f"CHAOS_BENCH_FAILED: {report['violations']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
