"""The chaos bench: the main soak and its six batteries (counterparts of the
JAX package's `tools/chaos_bench.py` `run_chaos` :163, `run_hotswap` :407,
`run_sessions` :867, `run_degraded` :1158, `run_autoscale` :1430,
`run_transport` :1781 and `run_federation` :1984, and of its `main`):
the soak, the live model operations and the degraded model, each against
one running `CompressionService`; the side-information sessions, against
services and a session-pinning `FrontDoorRouter`; the elastic fleet and
the federated fleet, against routers of real services on threads; the
shared-memory lanes, against a ring and routers of spawned replicas.

    python -m dsin_tpu_torch.tools.chaos_bench --smoke --device cpu \\
        --out /tmp/c.json                 # the soak, then all six batteries
    python -m dsin_tpu_torch.tools.chaos_bench --smoke --transport_only \\
        --device cpu --out /tmp/t.json
    python -m dsin_tpu_torch.tools.chaos_bench --smoke --hotswap_only \\
        --device cpu --out /tmp/h.json
    python -m dsin_tpu_torch.tools.chaos_bench --smoke --degraded_only \\
        --device cpu --out /tmp/d.json
    python -m dsin_tpu_torch.tools.chaos_bench --smoke --sessions_only \\
        --device cpu --out /tmp/s.json [--spawn_replicas]
    python -m dsin_tpu_torch.tools.chaos_bench --smoke --autoscale_only \\
        --device cpu --out /tmp/a.json
    python -m dsin_tpu_torch.tools.chaos_bench --smoke --federation_only \\
        --device cpu --out /tmp/f.json [--members N]

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

Autoscale battery (`--autoscale_only`, replicas on threads with SI,
quality and the canary prober every 0.15 s, the per-replica watchdog off):
(1) burst load makes the `Autoscaler` scale the fleet from 1 to 2; (2) a
bit-flipped twin promising the good model's goldens is force-committed
fleet-wide (`swap_model(canary=False)`) and the fleet-health driver, seeing
every replica's canary fail, rolls the fleet back conditionally; (3)
idleness drains the fleet to 1 and the drained replica's pinned session
answers `SessionExpired`; (4) the only live replica dies during a
scale-up: no hung future, the newcomer admitted with the fleet's bytes.
Federation battery (`--federation_only`, `--members` single-replica
fleets, default 3): one trace id across the federation, router and replica
spans; a staged two-wave rollout (checkpoints replicated into member
roots); a bit-flipped model force-committed onto wave 0 and caught by the
wave's canary gate; a member partitioned away mid-rollout, healed through
the aborted-digest reconcile; a member's death with pinned sessions.
Invariants in both: no hung future, every error typed, no torn version,
no native build after the publishing, a non-empty flight dump.

Main soak (the bare call, before the six batteries in the JAX order):
(A) `--requests` encodes under `serve.worker.batch` crash faults (at most
`--crashes`, each visit at `--crash_probability` after the first two) and
delay faults; the supervisor must restore `live_workers` to the configured
count and /healthz to ok (the health transitions are reported); (B)
bit-flipped streams must be refused at the door or fail their own future;
(C) `serve.rans` corruption after admission must fail each decode with
IntegrityError: zero false negatives in B and C; (D) clean decodes after
the chaos, and a non-empty flight dump. Invariants: no hung future, no
untyped error, no native build (`steady_builds`, where the JAX soak counts
XLA compiles). The JAX soak's `lock_discipline` section and its inversion
check are left out: the report says why (`LOCKS_NOT_PORTED`).

Lane battery (`--transport_only`): (1) every bit of a lane frame flipped
in the mapped segment must raise a typed error, never a wrong payload, and
descriptors that lie about the ring are refused; (2) one spawned replica
with one lane per class: a burst's claims that find no lane fall back to
the pipe typed and counted, every request served, no hung future; (3) one
replica of two SIGKILLed with descriptors in flight: futures resolve
(rerouted or typed), the survivor serves, and the /dev/shm census after
the battery equals the census before it. The census is of the segments
this process created (`shmlane.created_segments`: the router creates
every ring its replicas use), where the JAX census lists every "dsin-"
segment on the host, so that rings of other processes cannot move it. The
report carries each replica's kernel launches (`replica_kernel_launches`).

`--smoke` serves the tiny configuration (the JAX bench's smoke configs)
with the JAX smoke counts at seconds of CPU; without it the AE and PC
configs are `--ae_config` / `--pc_config`. Like every entry point of the
port it runs on the card unless `--device cpu` is given. Every battery's
violations gate the exit code: exit 1 on any; the report goes to `--out`
(default CHAOS_BENCH_TORCH.json, never the JAX bench's CHAOS_BENCH.json).
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
from dsin_tpu_torch.serve import shmlane as shmlane_lib
from dsin_tpu_torch.serve import (CanaryFailed, CompressionService,
                                  FrontDoorRouter, ServeError, ServiceConfig,
                                  SessionExpired)
from dsin_tpu_torch.train import checkpoint as ckpt_lib
from dsin_tpu_torch.utils import faults

LOCKS_NOT_PORTED = ("the JAX soak runs under ranked-lock enforcement and "
                    "gates on lock-order inversions; the port uses "
                    "threading.Lock and does not port ranked locks, by "
                    "design (ROADMAP, 'Not to port')")
#: the JAX main's order: the soak, then the six batteries
BATTERIES = ("hotswap", "sessions", "degraded_model", "autoscale",
             "transport", "federation")

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


def watchdog_rollbacks_since(service, before: int,
                             timeout_s: float = 10.0) -> int:
    """The watchdog's rollbacks since the count `before`. The watchdog
    counts its rollback once `rollback()` has returned, after the pointer
    flip a digest poll sees first: wait up to `timeout_s` for the count
    to move before reading it."""
    counter = service.metrics.counter("serve_watchdog_rollbacks")
    deadline = time.monotonic() + timeout_s
    while counter.value == before and time.monotonic() < deadline:
        time.sleep(0.01)
    return counter.value - before


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


def flip_bit(blob: bytes, bit: int) -> bytes:
    out = bytearray(blob)
    out[bit // 8] ^= 1 << (bit % 8)
    return bytes(out)


def run_chaos(args, images=None) -> dict:
    """The main soak (see the module docstring): phases A-D against one
    running service, its worker pool under crash and delay faults.
    `images` (H, W, 3) uint8, cycled by the encodes; default: noise at
    `--shapes`, the JAX soak's."""
    from dsin_tpu_torch.serve import IntegrityError

    shapes = parse_shapes(args.shapes)
    buckets = parse_shapes(args.buckets)
    # every injected fault that resolves a future typed, and every worker
    # death, must leave a non-empty flight dump behind
    flight_dir = tempfile.mkdtemp(prefix="chaos_flight_")
    cfg = ServiceConfig(
        ae_config=args.ae_config, pc_config=args.pc_config, ckpt=args.ckpt,
        seed=args.seed, buckets=buckets, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        workers=args.workers, entropy_workers=args.entropy_workers,
        entropy_backend=args.entropy_backend, transport=args.transport,
        pipeline_depth=args.pipeline_depth, restart_backoff_s=0.02,
        restart_backoff_max_s=0.25, trace_sample_rate=1.0,
        flight_dir=flight_dir, flight_dump_min_interval_s=0.0,
        device=args.device)
    service = CompressionService(cfg).start()
    warm = service.warmup()

    rng = np.random.default_rng(args.seed)
    if images is None:
        images = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                  for h, w in shapes]

    violations = []
    health_transitions = []

    def note_health():
        status = service.health()["status"]
        if not health_transitions or health_transitions[-1] != status:
            health_transitions.append(status)

    t0 = time.monotonic()
    builds = native_build.build_count()
    # -- phase A: encode load under crashes and slow batches --------------
    plan = faults.FaultPlan([
        faults.FaultSpec(site="serve.worker.batch", action="crash",
                         probability=args.crash_probability, after=2,
                         times=args.crashes),
        faults.FaultSpec(site="serve.worker.batch", action="delay",
                         probability=0.1, delay_s=0.02, times=10),
    ], seed=args.seed)
    futures, door_rejects = [], 0
    with faults.installed(plan):
        for i in range(args.requests):
            try:
                futures.append(service.submit_encode(
                    images[i % len(images)]))
            except ServeError:
                door_rejects += 1          # typed rejection at the door
            note_health()
            time.sleep(args.submit_gap_s)
        load_counts, load_hung = await_all(futures, args.timeout_s)

    # -- pool restoration after the crash phase ---------------------------
    restore_deadline = time.monotonic() + 10.0
    while (service.live_workers < cfg.workers
           and time.monotonic() < restore_deadline):
        time.sleep(0.02)
    note_health()
    pool_restored = service.live_workers == cfg.workers
    restarts = service.metrics.counter("serve_worker_restarts").value
    if plan.activations["serve.worker.batch"] == 0:
        violations.append("no faults fired in phase A (vacuous run)")
    if not pool_restored:
        violations.append(f"worker pool not restored: "
                          f"{service.live_workers}/{cfg.workers} live")
    if service.health()["status"] != "ok":
        violations.append(f"health did not return to ok: "
                          f"{service.health()}")

    # good streams for the integrity phases (done() first: a hung future
    # is reported as one, not raised here)
    good = [f.result(timeout=0) for f in futures
            if f.done() and f.exception(timeout=0) is None]
    if len(good) < 4:
        violations.append(f"only {len(good)} successful encodes — not "
                          f"enough to exercise integrity")

    # -- phase B: door integrity (bit-flipped frames at submit) ------------
    door_detected, door_missed = 0, 0
    for res in good[:args.corrupt_streams]:
        blob = res.stream
        bit = int(rng.integers(0, len(blob) * 8))
        try:
            f = service.submit_decode(flip_bit(blob, bit))
        except (ValueError, ServeError):
            # IntegrityError (CRC) or a structural ValueError: both are
            # detections, and nothing was admitted
            door_detected += 1
            continue
        if f.exception(timeout=args.timeout_s) is None:
            door_missed += 1           # decoded an image: false negative
        else:
            door_detected += 1

    # -- phase C: worker-side integrity (serve.rans corruption) ------------
    rans_plan = faults.FaultPlan([faults.FaultSpec(
        site="serve.rans", action="corrupt", probability=1.0)],
        seed=args.seed + 1)
    rans_detected, rans_missed = 0, 0
    with faults.installed(rans_plan):
        for res in good[:args.corrupt_streams]:
            f = service.submit_decode(res.stream)
            if isinstance(f.exception(timeout=args.timeout_s),
                          IntegrityError):
                rans_detected += 1
            else:
                rans_missed += 1
    if door_missed or rans_missed:
        violations.append(f"integrity false negatives: {door_missed} at "
                          f"the door, {rans_missed} worker-side")

    # -- phase D: the service still serves cleanly -------------------------
    clean_ok = 0
    for res in good[:args.decode_samples]:
        if service.decode(res.stream, timeout=args.timeout_s).ndim == 3:
            clean_ok += 1
    if clean_ok < min(args.decode_samples, len(good)):
        violations.append("fault-free decodes failed after the chaos")
    steady_builds = native_build.build_count() - builds

    if load_hung:
        violations.append(f"{load_hung} hung futures in phase A")
    if load_counts["untyped"]:
        violations.append(f"{load_counts['untyped']} untyped errors")
    if steady_builds:
        violations.append(f"{steady_builds} native builds in steady state "
                          f"(recovery must reuse the built libraries)")

    # the phases above fired worker crashes AND typed integrity errors,
    # both dump triggers: an empty recorder means the forensics are dead
    service.flight.flush(timeout=10.0)
    flight_meta = service.flight.meta()
    flight_last_events = 0
    if flight_meta["last_dump_path"]:
        with open(flight_meta["last_dump_path"]) as f:
            flight_last_events = sum(1 for _ in f) - 1   # minus the header
    if flight_meta["dumps"] < 1 or flight_last_events < 1:
        violations.append(
            f"injected faults produced no non-empty flight-recorder dump "
            f"({flight_meta['dumps']} dumps, last had {flight_last_events} "
            f"events)")
    crashes = service.metrics.counter("serve_worker_crashes").value
    service.drain()
    return {
        "config": {
            "shapes": [list(im.shape[:2]) for im in images],
            "buckets": [list(b) for b in buckets],
            "workers": args.workers,
            "entropy_workers": service._entropy_workers,
            "entropy_backend": args.entropy_backend,
            "transport": args.transport,
            "pipeline_depth": args.pipeline_depth,
            "max_batch": args.max_batch, "max_queue": args.max_queue,
            "requests": args.requests, "crashes": args.crashes,
            "crash_probability": args.crash_probability,
            "corrupt_streams": args.corrupt_streams,
            "seed": args.seed, "smoke": args.smoke, "device": args.device,
        },
        "warmup": warm,
        "load": {"submitted": len(futures), "door_rejects": door_rejects,
                 "completed_ok": load_counts["ok"],
                 "typed_errors": load_counts["typed"]},
        "faults_fired": {
            "serve.worker.batch": plan.activations["serve.worker.batch"],
            "serve.rans": rans_plan.activations["serve.rans"]},
        "supervision": {"worker_restarts": restarts,
                        "worker_crashes": crashes,
                        "pool_restored": pool_restored,
                        "health_transitions": health_transitions},
        "integrity": {
            "door": {"corrupted": door_detected + door_missed,
                     "detected": door_detected},
            "worker_side": {"corrupted": rans_detected + rans_missed,
                            "detected": rans_detected},
            "false_negatives": door_missed + rans_missed},
        "invariants": {"hung_futures": load_hung,
                       "untyped_errors": load_counts["untyped"],
                       "integrity_false_negatives": door_missed + rans_missed,
                       "flight_dumps": flight_meta["dumps"]},
        "flight_recorder": {"dumps": flight_meta["dumps"],
                            "events_in_ring": flight_meta["events"],
                            "last_dump_path": flight_meta["last_dump_path"],
                            "last_dump_events": flight_last_events},
        "lock_discipline": {"ported": False, "why": LOCKS_NOT_PORTED},
        "clean_decodes_after_chaos": clean_ok,
        "steady_builds": steady_builds,
        "duration_s": round(time.monotonic() - t0, 3),
        "violations": violations,
    }


def shm_census() -> list:
    """The segments this process created that are still in /dev/shm: the
    lane battery's leak evidence (the router creates every ring of its
    replicas; the children only attach)."""
    return [n for n in shmlane_lib.created_segments()
            if os.path.exists(os.path.join("/dev/shm", n))]


def transport_routers(args) -> dict:
    """The lane battery's two routers, each as a zero-argument callable
    that builds and starts it: one shm replica with one lane per class
    (lane exhaustion), two shm replicas polled every 0.1 s (replica
    death). A caller may start them ahead of the battery and pass
    callables that hand over the started routers."""
    cfg = ServiceConfig(
        ae_config=args.ae_config, pc_config=args.pc_config, ckpt=args.ckpt,
        seed=args.seed, buckets=parse_shapes(args.buckets),
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue, workers=args.workers,
        entropy_workers=args.entropy_workers,
        entropy_backend=args.entropy_backend,
        pipeline_depth=args.pipeline_depth, device=args.device)
    return {
        "lane_exhaustion": lambda: FrontDoorRouter(
            cfg, replicas=1, transport="shm",
            shm_lanes_per_class=1).start(),
        "replica_death_mid_descriptor": lambda: FrontDoorRouter(
            cfg, replicas=2, transport="shm", poll_every_s=0.1).start(),
    }


def router_segments(router) -> set:
    """The names of the lane rings a router created for its replicas."""
    return {ring.name for rep in router._all_replicas()
            for ring in (rep.rings or {}).values()}


def run_transport(args, image=None, routers=None, census_before=None,
                  foreign=None) -> dict:
    """The shared-memory lane battery (see the module docstring), three
    scenarios; `image` (H, W, 3) uint8 is what every request encodes
    (default: noise at the first bucket, the JAX battery's); `routers` the
    scenarios' router starters (default: `transport_routers(args)`). A
    caller that started the routers ahead passes the census it took before
    that (`census_before`), and `foreign()`, the segments of routers
    outside the battery alive at its end, which both censuses leave out.
    Smoke payloads pickle under SMALL_INLINE_MAX, so the battery drops the
    router's inline threshold to 1 for its duration: every dispatch rides
    a lane (the child resolves by descriptor type)."""
    from dsin_tpu_torch.serve import IntegrityError

    buckets = parse_shapes(args.buckets)
    violations = []
    scenarios = {}
    if census_before is None:
        census_before = shm_census()
    t0 = time.monotonic()

    # -- (1) lane corruption: every bit of a frame flipped in the segment --
    ring = shmlane_lib.LaneRing.create(
        "chaos", [shmlane_lib.LaneClass("c", 512, 2)])
    try:
        payload = bytes(range(96))
        ref = ring.put(payload)
        frame_bits = (shmlane_lib.FRAME_OVERHEAD + len(payload)) * 8
        caught = 0
        for bit in range(frame_bits):
            ring._shm.buf[ref.offset + bit // 8] ^= 1 << (bit % 8)
            try:
                ring.take(ref, free=False)
            except ValueError:           # IntegrityError is one
                caught += 1
            ring._shm.buf[ref.offset + bit // 8] ^= 1 << (bit % 8)
        pristine_ok = ring.take(ref) == payload
        ref2 = ring.put(b"g" * 100)
        liars = (
            (shmlane_lib.LaneRef(ref2.ring, ref2.cls, ref2.lane,
                                 ref2.offset, 64), IntegrityError),
            (shmlane_lib.LaneRef(ref2.ring, ref2.cls, ref2.lane,
                                 ref2.offset + 8, ref2.length),
             IntegrityError),
            (shmlane_lib.LaneRef("not-this-ring", ref2.cls, ref2.lane,
                                 ref2.offset, ref2.length),
             shmlane_lib.ShmLaneError),
        )
        geometry_refusals = 0
        for liar, exc_type in liars:
            try:
                ring.take(liar, free=False)
            except exc_type:
                geometry_refusals += 1
    finally:
        ring.unlink()
    if caught != frame_bits:
        violations.append(f"lane_corruption: {frame_bits - caught} of "
                          f"{frame_bits} single-bit flips read through "
                          f"undetected")
    if not pristine_ok:
        violations.append("lane_corruption: the restored frame no longer "
                          "reads back byte-identical")
    if geometry_refusals != len(liars):
        violations.append(f"lane_corruption: {len(liars) - geometry_refusals}"
                          f" lying descriptors were read through instead of "
                          f"refused")
    scenarios["lane_corruption"] = {
        "frame_bits": frame_bits, "flips_caught": caught,
        "pristine_readback": pristine_ok,
        "geometry_refusals": geometry_refusals,
        "expected_geometry_refusals": len(liars)}

    starters = routers if routers is not None else transport_routers(args)
    img = image
    if img is None:
        rng = np.random.default_rng(args.seed + 23)
        img = rng.integers(0, 255, (buckets[0][0], buckets[0][1], 3),
                           dtype=np.uint8)
    launches = {}
    inline_max = shmlane_lib.SMALL_INLINE_MAX
    shmlane_lib.SMALL_INLINE_MAX = 1
    try:
        # -- (2) lane exhaustion under a burst: typed fallback -------------
        router = starters["lane_exhaustion"]()
        try:
            futures = []
            for _ in range(args.requests):
                try:
                    futures.append(router.submit_encode(img))
                except ServeError:
                    pass                 # admission sheds are typed load
            counts, hung = await_all(futures, args.timeout_s)
            exhausted = router.metrics.counter(
                "serve_shm_fallback_exhausted").value
            sends = router.metrics.counter("serve_shm_sends").value
            integ = router.metrics.counter(
                "serve_shm_integrity_errors").value
            launches["lane_exhaustion"] = replica_launches(router)
        finally:
            router.drain(timeout_s=60)
        if exhausted < 1:
            violations.append("lane_exhaustion: a one-lane burst never "
                              "exhausted the ring — the scenario proved "
                              "nothing")
        if sends < 1:
            violations.append("lane_exhaustion: the lane transport never "
                              "ran (all sends fell back?)")
        if hung:
            violations.append(f"lane_exhaustion: {hung} hung futures")
        if counts["untyped"]:
            violations.append(f"lane_exhaustion: {counts['untyped']} "
                              f"untyped errors")
        if counts["ok"] == 0:
            violations.append("lane_exhaustion: no request completed — the "
                              "fallback path did not serve")
        if integ:
            violations.append(f"lane_exhaustion: {integ} lane integrity "
                              f"errors on an uncorrupted run")
        scenarios["lane_exhaustion"] = {
            "submitted": len(futures), "completed_ok": counts["ok"],
            "typed_errors": counts["typed"],
            "untyped_errors": counts["untyped"], "hung_futures": hung,
            "lane_sends": sends, "fallback_exhausted": exhausted,
            "integrity_errors": integ}

        # -- (3) replica death with descriptors in flight -------------------
        router = starters["replica_death_mid_descriptor"]()
        try:
            launches["replica_death_mid_descriptor"] = replica_launches(
                router)
            futures = [router.submit_encode(img)
                       for _ in range(min(args.requests, 16))]
            router._replicas[0].proc.kill()
            counts, hung = await_all(futures, args.timeout_s)
            deaths = router.metrics.counter(
                "serve_router_replica_deaths").value
            reroutes = router.metrics.counter("serve_router_reroutes").value
            survivor = router.encode(img, timeout=args.timeout_s)
            for idx, n in replica_launches(router).items():
                launches["replica_death_mid_descriptor"][idx] = n
        finally:
            router.drain(timeout_s=60)
        if deaths < 1:
            violations.append("replica_death_mid_descriptor: the kill was "
                              "never observed as a death")
        if hung:
            violations.append(f"replica_death_mid_descriptor: {hung} hung "
                              f"futures")
        if counts["untyped"]:
            violations.append(f"replica_death_mid_descriptor: "
                              f"{counts['untyped']} untyped errors")
        if survivor is None:
            violations.append("replica_death_mid_descriptor: the survivor "
                              "did not serve after the death")
        scenarios["replica_death_mid_descriptor"] = {
            "submitted": len(futures), "completed_ok": counts["ok"],
            "typed_errors": counts["typed"],
            "untyped_errors": counts["untyped"], "hung_futures": hung,
            "replica_deaths": deaths, "reroutes": reroutes}
    finally:
        shmlane_lib.SMALL_INLINE_MAX = inline_max

    census_after = shm_census()
    if foreign is not None:
        others = foreign()
        census_before = [n for n in census_before if n not in others]
        census_after = [n for n in census_after if n not in others]
    if census_after != census_before:
        violations.append(f"lane battery leaked shared memory: /dev/shm "
                          f"census went {census_before} -> {census_after}")
    return {
        "scenarios": scenarios,
        "shm_census": {"before": census_before, "after": census_after},
        "replica_kernel_launches": launches,
        "lock_discipline": {"ported": False, "why": LOCKS_NOT_PORTED},
        "duration_s": round(time.monotonic() - t0, 3),
        "violations": violations,
    }


def replica_launches(router) -> dict:
    """Each live replica's kernel launches, from its last scrape
    (`serve_kernel_launches`, see `serve_bench.replica_counts`); the
    counts a replica ends with, read before the router drains it."""
    from dsin_tpu_torch.tools.serve_bench import replica_counts
    return {k: v for k, v in replica_counts(router)["kernel_launches"].items()
            if v is not None}


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
    wd_rollbacks = watchdog_rollbacks_since(service, wd_before)
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
        #: False = every prepare skips its golden canary (the operator
        #: override, whatever the router sends)
        self.prepare_canary = True

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
                        ckpt, canary = protocol.parse_prepare(payload)
                        res = service.prepare_swap(
                            ckpt, canary=canary and self.prepare_canary)
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
    wd_rollbacks = watchdog_rollbacks_since(service, wd_before)
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


def fleet_config(args, buckets):
    """The autoscale and federation batteries' replicas: SI on, quality
    and the golden-canary prober on (every 0.15 s: the fleet-health and
    wave gates read it), every request traced, the per-replica watchdog
    OFF: these batteries hold the FLEET-level rollback, which must act
    alone."""
    return service_config(args, buckets, enable_si=True, session_max=8,
                          canary_every_s=0.15, quality_gap_sample_rate=1.0,
                          rollback_watchdog_window_s=None)


def publish_bad_twin(args, service, buckets, tmpd: str, seed_off: int = 1):
    """The canary publish flow on a warm `service`: a second model B is
    saved, prepared, its goldens recorded and the prepare aborted; then
    B's bit-flipped twin is saved PROMISING those goldens. -> (B's path,
    the twin's path). Publishing runs before any steady-state count."""
    state_b, extra = model_state(args, args.seed + seed_off, need_sinet=True)
    extra = {**extra, "buckets": [list(b) for b in buckets]}
    ckpt_b = os.path.join(tmpd, f"ckpt_b{seed_off}")
    ckpt_lib.save_checkpoint(ckpt_b, state_b, manifest_extra=extra)
    service.prepare_swap(ckpt_b, canary=False)
    goldens = service.canary_goldens(staged=True)
    service.abort_swap()
    ckpt_bad = os.path.join(tmpd, f"ckpt_bad{seed_off}")
    ckpt_lib.save_checkpoint(ckpt_bad, bitflip_params(state_b),
                             manifest_extra={**extra, "canary": goldens})
    return ckpt_b, ckpt_bad


def flight_evidence(flight, violations: list, label: str) -> dict:
    flight.flush(timeout=10.0)
    meta = flight.meta()
    last_events = 0
    if meta["last_dump_path"]:
        with open(meta["last_dump_path"]) as f:
            last_events = sum(1 for _ in f) - 1
    if meta["dumps"] < 1 or last_events < 1:
        violations.append(f"{label} left no non-empty flight dump "
                          f"({meta['dumps']} dumps, last had "
                          f"{last_events} events)")
    return {"dumps": meta["dumps"], "last_dump_events": last_events,
            "last_dump_path": meta["last_dump_path"]}


def run_autoscale(args) -> dict:
    """The elastic-fleet battery (see the module docstring)."""
    from dsin_tpu_torch.serve.autoscale import (Autoscaler, AutoscaleConfig,
                                                FleetHealthPolicy)

    buckets = [(16, 24), (32, 48)]
    flight_dir = tempfile.mkdtemp(prefix="chaos_autoscale_flight_")
    replicas = ThreadReplicas(lambda: fleet_config(args, buckets))
    router = FrontDoorRouter(
        fleet_config(args, buckets), replicas=1, launcher=replicas.launcher,
        poll_every_s=0.2, flight_dir=flight_dir).start()
    rng = np.random.default_rng(args.seed + 17)
    img = rng.integers(0, 255, (*buckets[0], 3), dtype=np.uint8)
    violations, scenarios = [], {}
    t0 = time.monotonic()
    digest_a = router.params_digest
    a_stream = router.encode(img, timeout=args.timeout_s).stream

    # -- (1) burst load scales the fleet up (the real control loop) -------
    scaler = Autoscaler(router, AutoscaleConfig(
        min_replicas=1, max_replicas=2, check_every_s=0.05,
        outstanding_high=4.0, outstanding_low=0.5, shed_high=1,
        hysteresis_checks=2, idle_checks=1000,   # this phase never drains
        up_cooldown_s=0.5, down_cooldown_s=3600.0)).start()
    futures = []
    deadline = time.monotonic() + args.timeout_s
    while router.health()["live"] < 2 and time.monotonic() < deadline:
        try:
            futures.append(router.submit_encode(img))
        except ServeError:
            pass                     # admission sheds are typed load
        time.sleep(args.submit_gap_s)
    scaler.stop()
    scaled_to = router.health()["live"]
    counts, hung = await_all(futures, args.timeout_s)
    if scaled_to < 2:
        violations.append("scale_up_burst: the autoscaler never scaled the "
                          "fleet up under burst load")
    if hung:
        violations.append(f"scale_up_burst: {hung} hung futures")
    if counts["untyped"]:
        violations.append(f"scale_up_burst: {counts['untyped']} untyped "
                          f"errors")
    scenarios["scale_up_burst"] = {
        "submitted": len(futures), "scaled_to": scaled_to,
        "completed_ok": counts["ok"], "typed_errors": counts["typed"],
        "untyped_errors": counts["untyped"], "hung_futures": hung,
        "scale_ups": router.metrics.counter("serve_router_scale_ups").value,
        "new_replica_warmup": replicas.warmups.get(1)}

    # -- (2) a canary-failing model rolled back fleet-wide ----------------
    tmpd = tempfile.mkdtemp(prefix="chaos_autoscale_")
    _, ckpt_bad = publish_bad_twin(args, replicas.services[0], buckets, tmpd)
    builds = native_build.build_count()
    swap_info = router.swap_model(ckpt_bad, canary=False)
    digest_bad = swap_info["digest"]
    # the evidence is the canary roll-up carrying the signal, measured
    # before the driver is armed
    canary_seen = 0
    deadline = time.monotonic() + args.timeout_s
    while time.monotonic() < deadline:
        q = router.aggregate.snapshot()["info"].get("quality", {})
        canary_seen = max(canary_seen,
                          len(q.get("replicas_canary_failing", [])))
        if canary_seen >= 2:
            break
        time.sleep(0.1)
    if canary_seen < 2:
        violations.append(f"sick_model_fleet_rollback: the canary roll-up "
                          f"never reported both replicas failing (saw "
                          f"{canary_seen})")
    # the fleet-health driver; its scale policy pinned shut (min = max =
    # live): only the unanimous-canary verdict can act
    health = Autoscaler(router, AutoscaleConfig(
        min_replicas=2, max_replicas=2, check_every_s=0.1),
        health_policy=FleetHealthPolicy(hysteresis_checks=2,
                                        cooldown_s=10.0)).start()
    t_arm = time.monotonic()
    fired = False
    deadline = time.monotonic() + args.timeout_s
    while time.monotonic() < deadline:
        if router.params_digest == digest_a:
            fired = True
            break
        time.sleep(0.05)
    rolled_s = time.monotonic() - t_arm
    health.stop()
    fleet_rollbacks = router.metrics.counter(
        "serve_autoscale_fleet_rollbacks").value
    per_replica = {str(i): s.model_digest
                   for i, s in replicas.services.items()}
    if not fired or fleet_rollbacks < 1:
        violations.append(f"sick_model_fleet_rollback: the canary roll-up "
                          f"did not drive a fleet rollback "
                          f"({fleet_rollbacks} fleet rollbacks, router "
                          f"digest {router.params_digest})")
    if any(d != digest_a for d in per_replica.values()):
        violations.append(f"sick_model_fleet_rollback: the fleet did not "
                          f"converge on the good model: {per_replica}")
    post = router.encode(img, timeout=args.timeout_s)
    if post.stream != a_stream:
        violations.append("sick_model_fleet_rollback: good-model "
                          "bit-identity lost after the rollback")
    scenarios["sick_model_fleet_rollback"] = {
        "digest_a": digest_a, "digest_bad": digest_bad, "fired": fired,
        "seconds_to_rollback": round(rolled_s, 3),
        "fleet_rollbacks": fleet_rollbacks,
        "canary_failing_seen": canary_seen,
        "digest_after": router.params_digest,
        "per_replica_digests": per_replica,
        "bit_identical_after": post.stream == a_stream}

    # -- (3) idleness drains the fleet; pinned sessions orphan typed ------
    sids = [router.open_session(img, timeout=args.timeout_s)
            for _ in range(2)]
    with router._lock:
        pin_of = {sid: router._sessions[sid] for sid in sids}
    orphans0 = router.metrics.counter("serve_router_session_orphans").value
    drainer = Autoscaler(router, AutoscaleConfig(
        min_replicas=1, max_replicas=2, check_every_s=0.05,
        outstanding_high=1e9,              # this phase never scales up
        outstanding_low=2.0, idle_checks=3,
        up_cooldown_s=0.0, down_cooldown_s=0.0)).start()
    deadline = time.monotonic() + args.timeout_s
    while router.health()["live"] > 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    drainer.stop()
    states = router.health()["replicas"]
    drained = [int(i) for i, s in states.items() if s == "drained"]
    if router.health()["live"] != 1 or not drained:
        violations.append(f"drain_down_idle: the fleet did not drain to 1 "
                          f"({states})")
    orphans = router.metrics.counter(
        "serve_router_session_orphans").value - orphans0
    orphaned_typed = survivor_ok = None
    stream = router.encode(img, timeout=args.timeout_s).stream
    for sid in sids:
        try:
            router.decode_si(stream, sid, timeout=args.timeout_s)
            ok = True
        except SessionExpired:
            ok = "expired"
        except Exception:  # noqa: BLE001 — a wrong type is a violation
            ok = False
        if pin_of[sid] in drained:
            orphaned_typed = ok == "expired"
        else:
            survivor_ok = ok is True
    if orphaned_typed is False:
        violations.append("drain_down_idle: the drained replica's pinned "
                          "session did not expire TYPED")
    if survivor_ok is False:
        violations.append("drain_down_idle: the survivor's pinned session "
                          "stopped serving")
    if orphaned_typed and orphans < 1:
        violations.append("drain_down_idle: a session was orphaned without "
                          "serve_router_session_orphans accounting")
    scenarios["drain_down_idle"] = {
        "drained_to": router.health()["live"], "drained_replicas": drained,
        "scale_downs": router.metrics.counter(
            "serve_router_scale_downs").value,
        "session_orphans": orphans,
        "orphaned_session_expired_typed": orphaned_typed,
        "survivor_session_ok": survivor_ok}
    steady_builds = native_build.build_count() - builds
    if steady_builds:
        violations.append(f"autoscale battery: {steady_builds} native "
                          f"builds across swap, rollback and drain")

    # -- (4) the only live replica dies DURING a scale-up -----------------
    live_idx = [int(i) for i, s in router.health()["replicas"].items()
                if s == "live"][0]
    futures = []
    for _ in range(4):
        try:
            futures.append(router.submit_encode(img))
        except ServeError:
            pass
    adder = {}
    t = threading.Thread(target=lambda: adder.update(
        info=router.add_replica()), name="chaos-scaleup")
    t.start()
    time.sleep(0.05)                  # the newcomer is building / warming
    replicas.kill(router, live_idx)   # ... and the only live replica dies
    t.join(args.timeout_s)
    admitted = not t.is_alive() and "info" in adder
    counts, hung = await_all(futures, args.timeout_s)
    if not admitted:
        violations.append("death_during_scale_up: add_replica did not "
                          "complete after the fleet died under it")
    if hung:
        violations.append(f"death_during_scale_up: {hung} hung futures")
    if counts["untyped"]:
        violations.append(f"death_during_scale_up: {counts['untyped']} "
                          f"untyped errors")
    post_admit_builds = None
    if admitted:
        tail0 = native_build.build_count()
        tail = [router.encode(img, timeout=args.timeout_s)
                for _ in range(3)]
        post_admit_builds = native_build.build_count() - tail0
        if post_admit_builds:
            violations.append(f"death_during_scale_up: {post_admit_builds} "
                              f"native builds after the admit")
        if any(res.stream != a_stream for res in tail):
            violations.append("death_during_scale_up: the admitted "
                              "replica's streams are not the fleet's")
    scenarios["death_during_scale_up"] = {
        "admitted": admitted,
        "new_replica": adder.get("info", {}).get("replica"),
        "typed_errors": counts["typed"], "untyped_errors": counts["untyped"],
        "hung_futures": hung,
        "replica_deaths": router.metrics.counter(
            "serve_router_replica_deaths").value,
        "post_admit_builds": post_admit_builds}
    flight = flight_evidence(router.flight, violations, "autoscale battery")
    counters = router.metrics.snapshot()["counters"]
    router.drain(timeout_s=60)
    return {"scenarios": scenarios,
            "autoscale_counters": {k: v for k, v in counters.items()
                                   if "scale" in k or "rollback" in k},
            "flight_recorder": flight, "steady_builds": steady_builds,
            "duration_s": round(time.monotonic() - t0, 3),
            "violations": violations}


def run_federation(args) -> dict:
    """The federated fleet battery (see the module docstring)."""
    from dsin_tpu_torch.serve.federation import (FederatedRouter, Member,
                                                 RolloutAborted,
                                                 RolloutPlan)

    buckets = [(16, 24), (32, 48)]
    flight_dir = tempfile.mkdtemp(prefix="chaos_federation_flight_")
    tmpd = tempfile.mkdtemp(prefix="chaos_federation_")
    names = tuple(f"m{i}" for i in range(args.members))
    fleets, routers, member_of = {}, {}, {}
    for name in names:
        fleet = ThreadReplicas(lambda: fleet_config(args, buckets))
        fleets[name] = fleet
        routers[name] = FrontDoorRouter(
            fleet_config(args, buckets), replicas=1,
            launcher=fleet.launcher, poll_every_s=0.2).start()
        # every member but m0 stages checkpoints into a root of its own
        # (the replicate_checkpoint path); m0 swaps from the shared dir
        member_of[name] = Member(
            name, routers[name], control_timeout_s=args.timeout_s,
            ckpt_root=(os.path.join(tmpd, f"root_{name}")
                       if name != "m0" else None))
    fed = FederatedRouter([member_of[n] for n in names], poll_every_s=0.1,
                          evict_after=2, trace_sample_rate=1.0,
                          flight_dir=flight_dir).start()
    rest = names[1:]
    rng = np.random.default_rng(args.seed + 23)
    img = rng.integers(0, 255, (*buckets[0], 3), dtype=np.uint8)
    violations, scenarios = [], {}
    t0 = time.monotonic()
    digest_a = fed.params_digest
    a_stream = fed.encode(img, timeout=args.timeout_s).stream
    if any(routers[n].encode(img, timeout=args.timeout_s).stream != a_stream
           for n in names):
        violations.append("setup: members are not bit-identical on the "
                          "seed model")

    def sweep():
        """Every version slot across both tiers: a committed federation
        shows ONE digest in every router and every replica service."""
        return {n: {"router": routers[n].params_digest,
                    "replica": fleets[n].services[0].model_digest}
                for n in names}

    def torn(expected, slots):
        return sorted(f"{n}.{slot}={d!r}" for n, per in slots.items()
                      for slot, d in per.items() if d != expected)

    # publishing runs before the steady-state count
    ckpt_b, ckpt_bad = publish_bad_twin(args, fleets["m0"].services[0],
                                        buckets, tmpd)
    state_c, extra_c = model_state(args, args.seed + 2, need_sinet=True)
    ckpt_c = os.path.join(tmpd, "ckpt_c")
    ckpt_lib.save_checkpoint(ckpt_c, state_c, manifest_extra={
        **extra_c, "buckets": [list(b) for b in buckets]})
    builds = native_build.build_count()

    # -- (1) one trace id stitched across both router tiers ---------------
    fut = fed.submit_encode(img)
    fut.result(args.timeout_s)
    tid = fut.trace.trace_id if fut.trace else None
    need = {"federation.dispatch", "router.dispatch", "queue.wait",
            "batch.device", "batch.entropy"}
    names_seen, merged = set(), {"members_scraped": 0}
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        merged = fed.traces.snapshot(trace_id=tid)
        names_seen = {s["name"] for s in merged["spans"]}
        if need <= names_seen:
            break
        time.sleep(0.05)
    missing = sorted(need - names_seen)
    if tid is None or missing:
        violations.append(f"federation_trace_stitch: trace {tid} is missing "
                          f"spans {missing} (got {sorted(names_seen)})")
    scenarios["federation_trace_stitch"] = {
        "trace_id": tid, "span_names": sorted(names_seen),
        "stitched": not missing,
        "members_scraped": merged["members_scraped"]}

    def plan(ckpt, **kw):
        return RolloutPlan(ckpt_dir=ckpt, waves=(("m0",), rest),
                           canary_timeout_s=args.timeout_s, poll_s=0.05,
                           swap_timeout_s=args.timeout_s,
                           rollback_timeout_s=args.timeout_s, **kw)

    # -- (2) the good model promotes wave by wave -------------------------
    res_b = fed.rollout(plan(ckpt_b, soak_s=0.3))
    digest_b = res_b["digest"]
    slots = sweep()
    torn_b = torn(digest_b, slots)
    b_stream = fed.encode(img, timeout=args.timeout_s).stream
    same = all(routers[n].encode(img, timeout=args.timeout_s).stream
               == b_stream for n in names)
    staged = {n: bool(ckpt_lib.latest_checkpoint(member_of[n].ckpt_root))
              for n in rest}
    if digest_b == digest_a:
        violations.append("staged_rollout: the promotion did not change the "
                          "federation's digest")
    if torn_b:
        violations.append(f"staged_rollout: torn versions after the full "
                          f"promotion: {torn_b}")
    if not same:
        violations.append("staged_rollout: members are not bit-identical "
                          "on the promoted model")
    if not all(staged.values()):
        violations.append(f"staged_rollout: replicate_checkpoint left no "
                          f"checkpoint in member roots ({staged})")
    scenarios["staged_rollout"] = {
        "digest_a": digest_a, "digest_b": digest_b, "waves": res_b["waves"],
        "version_sweep": slots, "torn_versions": torn_b,
        "distributed_roots_staged": staged, "bit_identical_members": same,
        "rollout_waves": fed.metrics.counter(
            "federation_rollout_waves").value}

    # -- (3) a bit-flipped model force-committed onto wave 0: the wave's
    # canary gate catches it through the serve path, the wave rolls back
    fleets["m0"].prepare_canary = False
    aborted_bad = None
    try:
        fed.rollout(plan(ckpt_bad, soak_s=0.0))
    except RolloutAborted as e:
        aborted_bad = e
    finally:
        fleets["m0"].prepare_canary = True
    slots = sweep()
    torn_bad = torn(digest_b, slots)
    post = fed.encode(img, timeout=args.timeout_s).stream
    if aborted_bad is None:
        violations.append("wave_canary_failure: the bad model promoted: the "
                          "wave canary gate never fired")
    elif aborted_bad.wave != 0 or "canary" not in aborted_bad.reason:
        violations.append(f"wave_canary_failure: aborted for the wrong "
                          f"reason (wave {aborted_bad.wave}: "
                          f"{aborted_bad.reason})")
    if torn_bad:
        violations.append(f"wave_canary_failure: torn versions after the "
                          f"abort: {torn_bad}")
    if post != b_stream:
        violations.append("wave_canary_failure: good-model bit-identity "
                          "lost after the wave rollback")
    scenarios["wave_canary_failure"] = {
        "aborted_typed": aborted_bad is not None,
        "abort_wave": getattr(aborted_bad, "wave", None),
        "abort_reason": getattr(aborted_bad, "reason", None),
        "wave0_outcome": (aborted_bad.per_wave.get(0, {}).get("m0")
                          if aborted_bad else None),
        "version_sweep": slots, "torn_versions": torn_bad,
        "bit_identical_after": post == b_stream,
        "rollout_aborts": fed.metrics.counter(
            "federation_rollout_aborts").value,
        "wave_rollbacks": fed.metrics.counter(
            "federation_rollout_wave_rollbacks").value}

    # -- (4) a member partitioned away mid-rollout, healed through the
    # aborted-digest reconcile --------------------------------------------
    victim = rest[0]

    def ambush():
        # partition the victim the moment wave 0 commits (m0's digest
        # moves): the rollout is mid-flight, wave 1 not yet started
        end = time.monotonic() + args.timeout_s
        while time.monotonic() < end:
            if routers["m0"].params_digest not in (None, digest_b):
                member_of[victim].partition()
                return
            time.sleep(0.005)

    amb = threading.Thread(target=ambush, name="chaos-fed-ambush")
    amb.start()
    aborted_c = None
    try:
        fed.rollout(plan(ckpt_c, soak_s=1.0, rollback_prior_waves=True))
    except RolloutAborted as e:
        aborted_c = e
    amb.join(args.timeout_s)
    if aborted_c is None:
        violations.append("partition_mid_rollout: the rollout PROMOTED "
                          "across a partitioned member")
    elif aborted_c.wave != 1:
        violations.append(f"partition_mid_rollout: aborted at wave "
                          f"{aborted_c.wave}, not at the partitioned wave "
                          f"({aborted_c.reason})")
    futures = []
    for _ in range(8):
        try:
            futures.append(fed.submit_encode(img))
        except ServeError:
            pass
    counts, hung = await_all(futures, args.timeout_s)
    survivor_stream = fed.encode(img, timeout=args.timeout_s).stream
    if hung:
        violations.append(f"partition_mid_rollout: {hung} hung futures "
                          f"during the partition")
    if counts["untyped"]:
        violations.append(f"partition_mid_rollout: {counts['untyped']} "
                          f"untyped errors")
    if survivor_stream != b_stream:
        violations.append("partition_mid_rollout: survivors lost good-model "
                          "bit-identity after the abort")
    # the partition ate the swap's answer, not the commit: the member
    # serves the digest the federation rolled away from
    routers[victim].swap_model(ckpt_c, prepare_timeout_s=args.timeout_s)
    stranded = routers[victim].params_digest
    member_of[victim].heal()
    reconciled = False
    deadline = time.monotonic() + args.timeout_s
    while time.monotonic() < deadline:
        if (fed.health()["members"].get(victim) == "live"
                and routers[victim].params_digest == digest_b):
            reconciled = True
            break
        time.sleep(0.05)
    reconciles = fed.metrics.counter("federation_reconciles").value
    slots = sweep()
    torn_c = torn(digest_b, slots)
    if not reconciled or reconciles < 1:
        violations.append(f"partition_mid_rollout: the healed member never "
                          f"reconciled off the aborted digest ({reconciles} "
                          f"reconciles, {victim} "
                          f"{fed.health()['members'].get(victim)!r}, digest "
                          f"{routers[victim].params_digest!r})")
    if torn_c:
        violations.append(f"partition_mid_rollout: torn versions after the "
                          f"heal: {torn_c}")
    scenarios["partition_mid_rollout"] = {
        "aborted_typed": aborted_c is not None,
        "abort_wave": getattr(aborted_c, "wave", None),
        "abort_reason": getattr(aborted_c, "reason", None),
        "prior_wave_outcome": (aborted_c.per_wave.get(0, {}).get("m0")
                               if aborted_c else None),
        "stranded_digest": stranded, "completed_ok": counts["ok"],
        "typed_errors": counts["typed"], "untyped_errors": counts["untyped"],
        "hung_futures": hung,
        "survivors_bit_identical": survivor_stream == b_stream,
        "reconciled": reconciled, "reconciles": reconciles,
        "readmissions": fed.metrics.counter(
            "federation_member_readmissions").value,
        "version_sweep": slots, "torn_versions": torn_c}

    # -- (5) a member's whole fleet dies with sessions pinned to it --------
    doomed = names[-1]
    pins = {}
    for _ in range(3 * len(names)):
        sid = fed.open_session(img, timeout=args.timeout_s)
        with fed._lock:
            pins[sid] = fed._sessions[sid]
        if doomed in pins.values() and len(set(pins.values())) >= 2:
            break
    victim_sid = next(s for s, n in pins.items() if n == doomed)
    survivor_sid = next(s for s, n in pins.items() if n != doomed)
    limits_before = dict(fed.admission.limits)
    stream = fed.encode(img, timeout=args.timeout_s).stream
    futures = []
    for _ in range(4):
        try:
            futures.append(fed.submit_encode(img))
        except ServeError:
            pass
    fleets[doomed].kill(routers[doomed], 0)
    evicted = False
    deadline = time.monotonic() + args.timeout_s
    while time.monotonic() < deadline:
        if fed.health()["members"].get(doomed) == "evicted":
            evicted = True
            break
        time.sleep(0.05)
    counts, hung = await_all(futures, args.timeout_s)
    try:
        fed.decode_si(stream, victim_sid, timeout=args.timeout_s)
        victim_typed = False
    except SessionExpired:
        victim_typed = True
    except Exception:  # noqa: BLE001 — a wrong type is a violation
        victim_typed = False
    try:
        fed.decode_si(stream, survivor_sid, timeout=args.timeout_s)
        survivor_ok = True
    except Exception:  # noqa: BLE001 — the survivor must serve
        survivor_ok = False
    limits_after = dict(fed.admission.limits)
    if not evicted:
        violations.append("member_death_pinned_sessions: the dead member "
                          "was never evicted on scrape evidence")
    if not victim_typed:
        violations.append("member_death_pinned_sessions: the dead member's "
                          "pinned session did not expire TYPED")
    if not survivor_ok:
        violations.append("member_death_pinned_sessions: a survivor's "
                          "pinned session stopped serving")
    if hung or counts["untyped"]:
        violations.append(f"member_death_pinned_sessions: {hung} hung, "
                          f"{counts['untyped']} untyped")
    if sum(limits_after.values()) >= sum(limits_before.values()):
        violations.append(f"member_death_pinned_sessions: the admission "
                          f"budget did not shrink with the member "
                          f"({limits_before} -> {limits_after})")
    scenarios["member_death_pinned_sessions"] = {
        "member": doomed, "evicted": evicted,
        "victim_session_expired_typed": victim_typed,
        "survivor_session_ok": survivor_ok,
        "typed_errors": counts["typed"], "untyped_errors": counts["untyped"],
        "hung_futures": hung, "budget_before": limits_before,
        "budget_after": limits_after}
    steady_builds = native_build.build_count() - builds
    if steady_builds:
        violations.append(f"federation battery: {steady_builds} native "
                          f"builds across rollouts, rollbacks and heals")
    flight = flight_evidence(fed.flight, violations, "federation battery")
    counters = fed.metrics.snapshot()["counters"]
    fed.drain()
    for name in names:
        routers[name].drain(timeout_s=60)
    return {"scenarios": scenarios,
            "federation_counters": {k: v for k, v in counters.items()
                                    if k.startswith("federation")},
            "flight_recorder": flight, "steady_builds": steady_builds,
            "duration_s": round(time.monotonic() - t0, 3),
            "violations": violations}


def parse_args(argv=None) -> argparse.Namespace:
    """The bench's flags, with `--smoke`'s configs and counts applied."""
    p = argparse.ArgumentParser(description="the port's chaos bench: the "
                                "main soak and its six batteries")
    p.add_argument("--ae_config", default=config_path("ae_kitti_stereo"))
    p.add_argument("--pc_config", default=config_path("pc_default"))
    p.add_argument("--ckpt", default=None,
                   help="soak and lane battery: serve this checkpoint "
                        "(default: seeded weights)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shapes", default="16,24 24,32 32,48")
    p.add_argument("--buckets", default="24,32 32,48")
    p.add_argument("--requests", type=int, default=120)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--entropy_workers", type=int, default=None)
    p.add_argument("--entropy_backend", default="thread",
                   choices=("thread", "process"))
    p.add_argument("--transport", default="pipe", choices=("pipe", "shm"),
                   help="the soak's service: the process backend's payload "
                        "transport")
    p.add_argument("--pipeline_depth", type=int, default=2)
    p.add_argument("--max_batch", type=int, default=2)
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--max_queue", type=int, default=64)
    p.add_argument("--crashes", type=int, default=4,
                   help="soak: most injected worker crashes in phase A")
    p.add_argument("--crash_probability", type=float, default=0.08)
    p.add_argument("--corrupt_streams", type=int, default=12)
    p.add_argument("--decode_samples", type=int, default=4)
    p.add_argument("--submit_gap_s", type=float, default=0.002)
    p.add_argument("--timeout_s", type=float, default=60.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="CHAOS_BENCH_TORCH.json")
    p.add_argument("--smoke", action="store_true",
                   help="the tiny smoke configs and the JAX smoke counts "
                        "(40 encodes, 2 crashes at probability 1.0, 6 "
                        "corrupt streams), seconds of CPU")
    p.add_argument("--hotswap_only", action="store_true",
                   help="the live-model-operations battery")
    p.add_argument("--degraded_only", action="store_true",
                   help="the degraded-model battery")
    p.add_argument("--sessions_only", action="store_true",
                   help="the side-information session battery")
    p.add_argument("--spawn_replicas", action="store_true",
                   help="session battery: spawned replica processes "
                        "behind the router (default: replicas on threads)")
    p.add_argument("--autoscale_only", action="store_true",
                   help="the elastic-fleet battery (Autoscaler, "
                        "fleet-health rollback)")
    p.add_argument("--federation_only", action="store_true",
                   help="the federated fleet battery (FederatedRouter)")
    p.add_argument("--members", type=int, default=3,
                   help="federation battery: member fleets (>= 2)")
    p.add_argument("--transport_only", action="store_true",
                   help="the shared-memory lane battery (in-segment bit "
                        "flips, lying descriptors, a one-lane exhaustion "
                        "burst, a replica's death with descriptors in "
                        "flight, the /dev/shm census)")
    args = p.parse_args(argv)
    if args.members < 2:
        p.error(f"--members must be >= 2, got {args.members}")
    resolve_device(args.device)
    if args.smoke:
        args.ae_config, args.pc_config = write_smoke_cfgs(tempfile.mkdtemp())
        args.requests = 40
        args.crashes = 2
        # p = 1.0: the capped 2 crashes fire at the first two eligible
        # visits whatever the batch timing (the JAX smoke's rule)
        args.crash_probability = 1.0
        args.corrupt_streams = 6
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    flags = {"hotswap": args.hotswap_only, "sessions": args.sessions_only,
             "degraded_model": args.degraded_only,
             "autoscale": args.autoscale_only,
             "transport": args.transport_only,
             "federation": args.federation_only}
    chosen = [name for name in BATTERIES if flags[name]]
    runners = {"hotswap": run_hotswap, "sessions": run_sessions,
               "degraded_model": run_degraded, "autoscale": run_autoscale,
               "transport": run_transport, "federation": run_federation}
    if chosen:
        report = {"config": {"smoke": args.smoke, "seed": args.seed,
                             "device": args.device}, "violations": []}
    else:
        # the bare call: the soak, then every battery in the JAX order
        report = run_chaos(args)
        chosen = list(BATTERIES)
    for name in chosen:
        report[name] = runners[name](args)
        report["violations"] = report["violations"] + \
            report[name]["violations"]
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
