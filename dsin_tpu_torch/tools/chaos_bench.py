"""Three batteries of the chaos bench (counterparts of the JAX package's
`tools/chaos_bench.py` `run_hotswap` :407, `run_sessions` :867 and
`run_degraded` :1158): the live model operations and the degraded model,
each against one running `CompressionService`, and the side-information
sessions, against services and a session-pinning `FrontDoorRouter`.

    python -m dsin_tpu_torch.tools.chaos_bench --smoke --hotswap_only \\
        --device cpu --out /tmp/h.json
    python -m dsin_tpu_torch.tools.chaos_bench --smoke --degraded_only \\
        --device cpu --out /tmp/d.json
    python -m dsin_tpu_torch.tools.chaos_bench --smoke --sessions_only \\
        --device cpu --out /tmp/s.json [--spawn_replicas]

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

Session battery (`--sessions_only`, SI buckets 16x24 and 32x48, which the
smoke configs' 8x12 patches tile): service A opens sessions past
`session_max` while `decode_si` work is in flight against older ones
(evictions under load) and takes `serve.session` faults at the door and
mid-batch; service B's session TTL expires between admission and batch
start; then a 2-replica router pins two sessions, one per replica, and
replica 0 dies with 8 SI requests in flight: they resolve typed, the
dead pin answers `SessionExpired` at the door, the survivor's session
serves, a new session opens, `serve_router_session_orphans` counts it;
and one `decode_si` through the door is traced end to end (the router's
`router.dispatch` span and the replica's queue, device, entropy, session
and search spans under one trace id, through the fleet's `/trace`). The
replicas are real services on threads of this process (`ThreadReplicas`,
a hard kill closes the pipe with work in flight), or with
`--spawn_replicas` spawned processes (the kill is a SIGKILL).
Invariants: no hung future, every error typed, no native build after
warmup.

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
import multiprocessing
import os
import queue
import sys
import tempfile
import threading
import time
from dataclasses import replace

import numpy as np

from dsin_tpu_torch import native_build
from dsin_tpu_torch.coding.loader import tree_leaves
from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.runtime import config_path, resolve_device
from dsin_tpu_torch.serve import protocol
from dsin_tpu_torch.serve import router as router_lib
from dsin_tpu_torch.serve import (CanaryFailed, CompressionService,
                                  FrontDoorRouter, ServeError, ServiceConfig,
                                  SessionExpired)
from dsin_tpu_torch.train import checkpoint as ckpt_lib
from dsin_tpu_torch.utils import faults

ROADMAP_CHAOS = ("ROADMAP Queue 1 item 11g (the rest of the chaos bench: "
                 "the main soak, autoscale, transport and federation "
                 "batteries)")

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


class ThreadReplicas:
    """FrontDoorRouter launcher whose replicas are threads of this process
    running REAL CompressionServices and speaking the pipe protocol (the
    JAX bench's `_ThreadReplicas`). `kill(idx)` makes the replica close
    its own pipe end on its own thread WITHOUT draining its in-flight SI
    work: the router's reader sees the EOF a process crash produces while
    requests are still outstanding."""

    def __init__(self, make_config):
        self._make_config = make_config
        self.dead = {}
        self.threads = {}
        self.services = {}
        self.warmups = {}

    def launcher(self, config, idx, ctx):
        parent, child = multiprocessing.Pipe(duplex=True)
        self.dead[idx] = threading.Event()
        t = threading.Thread(target=self._run, args=(idx, child),
                             name=f"chaos-si-replica-{idx}", daemon=True)
        self.threads[idx] = t
        t.start()
        return None, parent

    def _run(self, idx, conn):
        try:
            # a real metrics endpoint per replica: the router's /trace
            # aggregation scrapes it as it scrapes a spawned replica's
            service = CompressionService(
                replace(self._make_config(), metrics_port=0)).start()
            self.warmups[idx] = service.warmup()
        except BaseException as e:  # noqa: BLE001 — the router needs it
            conn.send(("failed", idx, router_lib._picklable_exc(e)))
            conn.close()
            return
        self.services[idx] = service
        outq = queue.Queue()

        def _sender():
            while True:
                item = outq.get()
                if item is None:
                    return
                try:
                    conn.send(item)
                except (OSError, ValueError, BrokenPipeError):
                    return

        sender = threading.Thread(target=_sender, daemon=True,
                                  name=f"chaos-si-send-{idx}")
        sender.start()
        outq.put(("ready", idx, {
            "replica": idx, "pid": os.getpid(),
            "healthz_port": service.metrics_port,
            "builds_at_ready": native_build.build_count(),
            "params_digest": service.model_digest}))
        dead = self.dead[idx]

        def _complete(rid_, fut_):
            exc = fut_.exception(timeout=0)
            if exc is None:
                outq.put(("ok", rid_, fut_.result(timeout=0)))
            else:
                outq.put(("err", rid_, router_lib._picklable_exc(exc)))

        while not dead.is_set():
            try:
                if not conn.poll(0.02):
                    continue
                msg = conn.recv()
            except (EOFError, OSError):
                break
            if msg[0] == protocol.STOP:
                break
            op, rid, payload, priority, deadline_ms, trace = \
                protocol.parse_request(msg)
            try:
                if op in protocol.CONTROL_OPS:
                    if op == "swap_prepare":
                        res = service.prepare_swap(payload)
                    elif op == "swap_commit":
                        res = service.commit_swap(expect_digest=payload)
                    elif op == "swap_abort":
                        res = service.abort_swap()
                    else:
                        res = service.rollback(expect_current=payload)
                    outq.put(("ok", rid, res))
                    continue
                if op == "session_open":
                    outq.put(("ok", rid, service.open_session(payload)))
                    continue
                if op == "session_close":
                    outq.put(("ok", rid, service.close_session(payload)))
                    continue
                if op == "encode":
                    fut = service.submit_encode(
                        payload, deadline_ms=deadline_ms, priority=priority,
                        trace=trace)
                elif op == "decode_si":
                    fut = service.submit_decode_si(
                        payload[0], payload[1], deadline_ms=deadline_ms,
                        priority=priority, trace=trace)
                else:
                    fut = service.submit_decode(
                        payload, deadline_ms=deadline_ms, priority=priority,
                        trace=trace)
            except BaseException as e:  # noqa: BLE001 — typed rejects
                outq.put(("err", rid, router_lib._picklable_exc(e)))
                continue
            fut.add_done_callback(lambda f, rid_=rid: _complete(rid_, f))
        # a HARD death (kill) closes the pipe with work still in flight:
        # the router must type those futures, not this replica. A
        # graceful stop drains first.
        if not dead.is_set():
            service.drain()
        outq.put(None)
        sender.join(timeout=10)
        try:
            conn.close()
        except OSError:
            pass
        if dead.is_set():
            service.drain()

    def kill(self, router, idx):
        self.dead[idx].set()
        self.threads[idx].join(timeout=60)


class SpawnKiller:
    """The spawned-replica counterpart of ThreadReplicas.kill: SIGKILL the
    replica's process."""

    launcher = None

    @staticmethod
    def kill(router, idx):
        import signal
        proc = router._replicas[idx].proc
        os.kill(proc.pid, signal.SIGKILL)
        proc.join(timeout=60)


def run_sessions(args) -> dict:
    """The side-information session battery (see the module docstring)."""
    from dsin_tpu_torch.serve.session import SessionError

    buckets = [(16, 24), (32, 48)]
    base = dict(
        ae_config=args.ae_config, pc_config=args.pc_config, seed=args.seed,
        buckets=buckets, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        workers=args.workers, entropy_workers=args.entropy_workers,
        entropy_backend=args.entropy_backend,
        pipeline_depth=args.pipeline_depth, enable_si=True,
        trace_sample_rate=1.0, device=args.device)
    rng = np.random.default_rng(args.seed + 11)
    sides = {tuple(b): rng.integers(0, 255, (b[0], b[1], 3), dtype=np.uint8)
             for b in buckets}
    violations, scenarios = [], {}
    t0 = time.monotonic()
    bucket = tuple(buckets[0])

    # -- service A: evict-under-load + serve.session faults ------------------
    svc = CompressionService(ServiceConfig(**base, session_max=2)).start()
    warm = svc.warmup()
    builds = native_build.build_count()
    try:
        stream = svc.encode(sides[bucket], timeout=args.timeout_s).stream
        # (1) open past session_max while decode_si load is IN FLIGHT
        # against older sessions
        futures, door_expired, sids = [], 0, []
        for _ in range(6):
            sids.append(svc.open_session(sides[bucket]))
            for sid in sids:
                try:
                    futures.append(svc.submit_decode_si(stream, sid))
                except (SessionExpired, SessionError):
                    door_expired += 1
        counts, hung = await_all(futures, args.timeout_s)
        evictions = svc.metrics.counter("serve_session_evictions").value
        if hung:
            violations.append(f"evict_under_load: {hung} hung futures")
        if counts["untyped"]:
            violations.append(f"evict_under_load: {counts['untyped']} "
                              f"untyped errors")
        if evictions == 0:
            violations.append("evict_under_load: no eviction fired "
                              "(vacuous: session_max never engaged)")
        scenarios["evict_under_load"] = {
            "opened": len(sids), "submitted": len(futures),
            "door_expired": door_expired, "completed_ok": counts["ok"],
            "typed_errors": counts["typed"], "hung_futures": hung,
            "untyped_errors": counts["untyped"], "evictions": evictions}
        # (2) a serve.session fault at the DOOR (visit 1: submit's get)
        plan = faults.FaultPlan([faults.FaultSpec(
            site="serve.session", action="raise", times=1)], seed=args.seed)
        door_typed = False
        with faults.installed(plan):
            try:
                svc.submit_decode_si(stream, sids[-1])
            except faults.InjectedFault:
                door_typed = True
        # (3) the fault MID-BATCH (the door passes, the worker's
        # batch-start lookup fires): the future fails typed
        plan2 = faults.FaultPlan([faults.FaultSpec(
            site="serve.session", action="raise", after=1, times=1)],
            seed=args.seed)
        with faults.installed(plan2):
            f = svc.submit_decode_si(stream, sids[-1])
            mid_typed = isinstance(f.exception(timeout=args.timeout_s),
                                   faults.InjectedFault)
        if not (door_typed and mid_typed):
            violations.append(f"session_fault: injected serve.session "
                              f"faults not answered typed (door="
                              f"{door_typed}, mid={mid_typed})")
        clean = svc.decode_si(stream, sids[-1], timeout=args.timeout_s)
        scenarios["session_fault"] = {
            "door_typed": door_typed, "mid_batch_typed": mid_typed,
            "clean_after": bool(clean.ndim == 3),
            "fired": plan.activations["serve.session"]
            + plan2.activations["serve.session"]}
    finally:
        svc.drain()

    # -- service B: TTL expiry mid-batch -------------------------------------
    svc_b = CompressionService(ServiceConfig(
        **{**base, "max_wait_ms": 400.0, "max_batch": 4},
        session_max=4, session_ttl_s=0.15)).start()
    svc_b.warmup()
    try:
        stream_b = svc_b.encode(sides[bucket], timeout=args.timeout_s).stream
        sid = svc_b.open_session(sides[bucket])
        futs = [svc_b.submit_decode_si(stream_b, sid) for _ in range(2)]
        expired_typed = hung_b = untyped_b = 0
        for f in futs:
            try:
                exc = f.exception(timeout=args.timeout_s)
            except TimeoutError:
                hung_b += 1
                continue
            if isinstance(exc, SessionExpired):
                expired_typed += 1
            elif exc is not None:
                untyped_b += 1
        if expired_typed != len(futs) or hung_b or untyped_b:
            violations.append(
                f"expire_mid_batch: {expired_typed}/{len(futs)} typed "
                f"SessionExpired, {hung_b} hung, {untyped_b} other")
        # a fresh session serves after the expiry: a FULL batch pops at
        # once, inside the TTL (the 400 ms coalesce window exceeds it)
        sid2 = svc_b.open_session(sides[bucket])
        futs_after = [svc_b.submit_decode_si(stream_b, sid2)
                      for _ in range(4)]
        ok_after = all(f.exception(timeout=args.timeout_s) is None
                       for f in futs_after)
    finally:
        svc_b.drain()
    scenarios["expire_mid_batch"] = {
        "submitted": len(futs), "expired_typed": expired_typed,
        "hung_futures": hung_b, "untyped_errors": untyped_b,
        "fresh_session_after": ok_after}

    # -- a replica's death with live sessions (the session-pinning router) --
    reps = (SpawnKiller() if args.spawn_replicas
            else ThreadReplicas(lambda: ServiceConfig(**base, session_max=4)))
    router = FrontDoorRouter(ServiceConfig(**base, session_max=4),
                             replicas=2, launcher=reps.launcher,
                             poll_every_s=30.0,
                             trace_sample_rate=1.0).start()
    try:
        stream_r = router.encode(sides[bucket], timeout=args.timeout_s).stream
        sid_a = router.open_session(sides[bucket])   # rr -> replica 0
        sid_b = router.open_session(sides[bucket])   # rr -> replica 1
        pin_a = router._sessions[sid_a]
        in_flight = [router.submit_decode_si(stream_r, sid_a)
                     for _ in range(8)]
        reps.kill(router, pin_a)
        counts_r, hung_r = await_all(in_flight, args.timeout_s)
        deadline = time.monotonic() + args.timeout_s
        while router.health()["replicas"][str(pin_a)] != "dead" \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        door_after = False
        try:
            router.submit_decode_si(stream_r, sid_a)
        except SessionExpired:
            door_after = True
        survivor_ok = router.decode_si(
            stream_r, sid_b, timeout=args.timeout_s).ndim == 3
        sid_c = router.open_session(sides[bucket])
        new_open_ok = router.decode_si(
            stream_r, sid_c, timeout=args.timeout_s).ndim == 3
        orphans = router.metrics.counter(
            "serve_router_session_orphans").value
        if hung_r:
            violations.append(f"replica_death: {hung_r} hung SI futures")
        if counts_r["untyped"]:
            violations.append(f"replica_death: {counts_r['untyped']} "
                              f"untyped errors")
        if not door_after:
            violations.append("replica_death: the dead replica's session "
                              "is still pinned (the door did not expire "
                              "it typed)")
        if not (survivor_ok and new_open_ok):
            violations.append("replica_death: the surviving replica "
                              "stopped serving sessions")
        if orphans < 1:
            violations.append("replica_death: no session orphan was "
                              "recorded (pin table not cleaned)")
        scenarios["replica_death"] = {
            "replicas": "spawned" if args.spawn_replicas else "threads",
            "in_flight": len(in_flight), "completed_ok": counts_r["ok"],
            "typed_errors": counts_r["typed"],
            "untyped_errors": counts_r["untyped"], "hung_futures": hung_r,
            "door_expired_after_death": door_after,
            "survivor_serves": survivor_ok,
            "new_session_after_death": new_open_ok,
            "session_orphans": orphans}

        # -- one decode_si through the door, traced end to end ----------------
        fut = router.submit_decode_si(stream_r, sid_c)
        fut.result(args.timeout_s)
        tid = fut.trace.trace_id
        need = {"router.dispatch", "queue.wait", "batch.device",
                "batch.entropy", "batch.si_search", "session.lookup"}
        names, merged = set(), {"replicas_scraped": 0}
        deadline = time.monotonic() + 10.0
        # the replica publishes its batch spans when the batch finishes,
        # moments after the future resolves
        while time.monotonic() < deadline:
            merged = router.traces.snapshot(trace_id=tid)
            names = {sp["name"] for sp in merged["spans"]}
            if need <= names:
                break
            time.sleep(0.05)
        missing = sorted(need - names)
        if missing:
            violations.append(f"trace_stitch: front-door decode_si trace "
                              f"{tid} is missing spans {missing} (got "
                              f"{sorted(names)})")
        scenarios["trace_stitch"] = {
            "trace_id": tid, "span_names": sorted(names),
            "stitched": not missing,
            "replicas_scraped": merged["replicas_scraped"]}
    finally:
        router.drain()
    steady_builds = native_build.build_count() - builds
    if steady_builds:
        violations.append(f"session battery: {steady_builds} native builds "
                          f"after warmup")
    return {"warmup": warm, "scenarios": scenarios,
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
                                "hot-swap, session and degraded-model "
                                "batteries")
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
    p.add_argument("--sessions_only", action="store_true",
                   help="the side-information session battery")
    p.add_argument("--spawn_replicas", action="store_true",
                   help="session battery: spawned replica processes "
                        "behind the router (default: replicas on threads)")
    for name in ("autoscale_only", "transport_only", "federation_only"):
        p.add_argument(f"--{name}", action="store_true",
                       help=f"not ported: {ROADMAP_CHAOS}")
    args = p.parse_args(argv)
    for name in ("autoscale_only", "transport_only", "federation_only"):
        if getattr(args, name):
            p.error(f"--{name} is not ported to dsin_tpu_torch yet: "
                    f"{ROADMAP_CHAOS}")
    if not (args.hotswap_only or args.degraded_only or args.sessions_only):
        p.error(f"choose --hotswap_only, --sessions_only or "
                f"--degraded_only; the main soak is not ported to "
                f"dsin_tpu_torch yet: {ROADMAP_CHAOS}")
    resolve_device(args.device)
    if args.smoke:
        args.ae_config, args.pc_config = write_smoke_cfgs(tempfile.mkdtemp())
    report = {"config": {"smoke": args.smoke, "seed": args.seed,
                         "device": args.device}, "violations": []}
    if args.hotswap_only:
        report["hotswap"] = run_hotswap(args)
        report["violations"] += report["hotswap"]["violations"]
    if args.sessions_only:
        report["sessions"] = run_sessions(args)
        report["violations"] += report["sessions"]["violations"]
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
