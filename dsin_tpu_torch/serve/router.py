"""Multi-replica front door: admission control + shared-nothing scale-out
(a copy of the JAX package's `serve/router.py`, in PyTorch's idiom).

* **AdmissionController** — the front-door gate. Tracks per-class
  OUTSTANDING work (queued + in-flight, incremented at admit and
  released by a `Future.add_done_callback` the moment the answer lands)
  and sheds BEFORE anything is enqueued, pickled, or shipped to a
  replica: a rejected request costs one counter read. Sheds raise the
  typed per-class `ServiceOverloaded` the batcher uses; per-class
  `serve_admitted_<cls>` / `serve_shed_admission_<cls>` counters export
  the decisions. The in-process service (`serve/service.py`) wears the
  same gate when it has priority classes.

* **FrontDoorRouter** — one router (the caller's process) in front of N
  SHARED-NOTHING service replicas. Each replica is a full
  `CompressionService` in its own process, started with the `spawn`
  context (never fork: the parent may hold a CUDA context), on the
  config's `device` (the card unless the caller asks for "cpu"; a child
  without a card raises at start, it never falls back). The picklable
  `ServiceConfig` is the entire bootstrap; each replica answers its
  `params_digest` at the ready handshake and the router REFUSES a fleet
  whose replicas built different models. The handshake also carries
  `builds_at_ready` (`native_build.build_count()` once the child is warm)
  and the warmup's `builds`, where the JAX child reports compile counts.
  Routing is round-robin PER CLASS over the live replicas; per-replica
  `/healthz` polling feeds eviction after `evict_after` consecutive
  failures and readmission on the next healthy poll. A replica that DIES
  with requests in flight does not fail its callers: the reader thread
  re-dispatches each encode/decode once to a live replica with the
  REMAINING deadline, failing typed `ServiceUnavailable` only when no
  replica remains. Every future resolves exactly once.

Fleet hot swap: `swap_model(ckpt_dir)` drives the service's
`prepare_swap` / `commit_swap` / `abort_swap` / `rollback`
(`serve/swap.py`) as a TWO-PHASE commit: every live replica prepares and
reports the digest it built; only on a unanimous digest does the router
gate new dispatches for the O(1) commits. A prepare failure aborts the
fleet; a commit failure rolls the committed replicas back.
`rollback(expect_digest=...)` is conditional per replica.

Session pinning: an SI session's prep lives in exactly one replica's
store, so `open_session` pins the sid to the replica it opened on and
every `submit_decode_si` for it goes there. A dead pinned replica's
in-flight SI work and later submits fail typed `SessionExpired`;
`serve_router_session_orphans` counts the pins lost.

Elastic fleet: `add_replica()` admits a newcomer only after its warm
handshake and a digest match (`FleetScaleError` otherwise);
`drain_replica()` leaves the rotation through `_leave_rotation`, the one
path a death uses too; `prewarm_template` keeps one warmed spare out of
the rotation so an add is a handshake.

Observability: `metrics_port` serves ONE endpoint merging every replica's
snapshot (`AggregatedMetrics`: sums, histogram folds, per-replica digests
and info, stale scrapes excluded), and `/trace` stitches the router's
`router.dispatch` spans with every replica's ring (`AggregatedTraces`).
The router mints the front-door `TraceContext`; it rides the pipe with
every (re)dispatch and the replica honours its sampling decision.

Locks: `threading.Lock` stands where the JAX package ranks its locks.
The frontdoor lock guards the replica table and the rr counters; a
replica's lock guards its in-flight map and serializes its pipe sends;
the admission lock is a LEAF (nothing is called while it is held), since
its release callback may run under the batcher's condition when a shed
resolves a victim.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import urllib.request
from dataclasses import replace
from typing import Any, Dict, List, Mapping, Optional, Tuple

from dsin_tpu_torch import native_build
from dsin_tpu_torch.serve import metrics as metrics_lib
from dsin_tpu_torch.serve import protocol
from dsin_tpu_torch.serve import shmlane
from dsin_tpu_torch.serve import trace as trace_lib
from dsin_tpu_torch.serve.batcher import (DeadlineExceeded, Future,
                                          ServeError, ServiceOverloaded,
                                          ServiceUnavailable,
                                          UnknownPriorityClass)
from dsin_tpu_torch.serve.session import SessionExpired
from dsin_tpu_torch.serve.swap import SwapError

#: re-exported from serve/protocol.py (the one shared definition the
#: router parent and the replica child both parse by)
CONTROL_OPS = protocol.CONTROL_OPS

#: how long _dispatch will wait on the commit gate before proceeding
#: anyway (fail-open: a wedged swap must degrade to pre-swap routing,
#: never to a frozen front door)
_SWAP_GATE_TIMEOUT_S = 10.0


class FleetSwapError(RuntimeError):
    """A fleet-coordinated swap did not converge on the NEW model: a
    prepare failed or disagreed (fleet aborted, old model serving), or
    a commit failed partway (committed replicas rolled back). Carries
    `per_replica` — {replica_idx: outcome-or-exception} — so the
    operator sees exactly which replica refused and why."""

    def __init__(self, msg: str, per_replica: Optional[Dict] = None):
        super().__init__(msg)
        self.per_replica = dict(per_replica or {})


class FleetScaleError(RuntimeError):
    """A runtime fleet mutation (add_replica/drain_replica) was refused
    or failed: the newcomer built a DIFFERENT model than the fleet
    serves (it was killed before it could take traffic), a second scale
    op raced the first, a scale op raced a fleet swap, or a drain would
    empty the fleet. The current rotation keeps serving either way."""


def default_admission_limits(config) -> Dict[str, int]:
    """ONE process's worth of admissible backlog per class: the class's
    queue bound plus everything the executor pipelines can hold in
    flight — max_batch * workers * pipeline_depth * devices (workers
    are PER-DEVICE executor threads). Shared by the in-process service
    gate and the front door (which scales it by replica count) so the
    two derivations cannot drift."""
    slack = (config.max_batch * max(1, config.workers)
             * max(1, config.pipeline_depth)
             * (1 if getattr(config, "devices", None) is None
                else max(1, config.devices)))
    classes = getattr(config, "priority_classes", None)
    if classes:
        return {pc.name: pc.max_queue + slack for pc in classes}
    return {"default": config.max_queue + slack}


class AdmissionController:
    """Per-class outstanding-work caps, enforced at the door.

    `limits` maps class name -> max outstanding (queued + in-flight)
    requests. `admit(cls)` either takes a slot or raises a typed
    per-class ServiceOverloaded — cheap rejection, nothing enqueued;
    `attach(cls, future)` arranges the release on resolution (success,
    shed, expiry, crash — any resolution frees the slot)."""

    def __init__(self, limits: Mapping[str, int],
                 metrics: Optional[metrics_lib.MetricsRegistry] = None):
        if not limits:
            raise ValueError("admission control needs at least one "
                             "class limit")
        bad = {c: n for c, n in limits.items() if int(n) < 1}
        if bad:
            raise ValueError(f"admission limits must be >= 1: {bad}")
        self.limits: Dict[str, int] = {str(c): int(n)
                                       for c, n in limits.items()}
        self.metrics = (metrics if metrics is not None
                        else metrics_lib.MetricsRegistry())
        self._lock = threading.Lock()
        self._outstanding: Dict[str, int] = {
            c: 0 for c in self.limits}     # guarded-by: self._lock

    def admit(self, cls: str) -> None:
        limit = self.limits.get(cls)
        if limit is None:
            raise UnknownPriorityClass(
                f"unknown priority class {cls!r} "
                f"(admission classes: {sorted(self.limits)})")
        with self._lock:
            n = self._outstanding[cls]
            shed = n >= limit
            if not shed:
                self._outstanding[cls] = n + 1
        if shed:
            self.metrics.counter(f"serve_shed_admission_{cls}").inc()
            raise ServiceOverloaded(
                f"admission control: class {cls!r} at capacity "
                f"({n}/{limit} outstanding) — shed before enqueue",
                priority=cls, depth=n)
        self.metrics.counter(f"serve_admitted_{cls}").inc()

    def release(self, cls: str) -> None:
        with self._lock:
            self._outstanding[cls] = max(0, self._outstanding[cls] - 1)

    def set_limits(self, limits: Mapping[str, int]) -> None:
        """Resize the per-class caps in place (the router
        rescales its derived aggregate caps when the fleet grows or
        shrinks — scaled-up capacity behind the old cap would shed the
        very load the scale-up was fired to absorb). The CLASS SET is
        fixed at construction; shrinking below the current outstanding
        simply sheds new admits until the backlog drains."""
        bad = {c: n for c, n in limits.items() if int(n) < 1}
        if bad:
            raise ValueError(f"admission limits must be >= 1: {bad}")
        with self._lock:
            if set(map(str, limits)) != set(self._outstanding):
                raise ValueError(
                    f"admission classes are fixed at construction "
                    f"(have {sorted(self._outstanding)}, got "
                    f"{sorted(map(str, limits))})")
            self.limits = {str(c): int(n) for c, n in limits.items()}

    def attach(self, cls: str, future: Future) -> None:
        """Release the class slot the moment `future` resolves (runs on
        the resolving thread, possibly under the batcher's condition:
        `release` takes only the admission lock, a leaf)."""
        future.add_done_callback(lambda _f: self.release(cls))

    def outstanding(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._outstanding)


# -- replica child ------------------------------------------------------------

def _picklable_exc(exc: BaseException) -> BaseException:
    """Exceptions cross the pipe; one that cannot pickle (exotic ctor)
    degrades to a RuntimeError carrying its repr rather than killing
    the sender."""
    import pickle
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:
        return RuntimeError(f"{type(exc).__name__}: {exc}")


def _replica_main(conn, config, replica_id: int, lanes=None) -> None:
    """Spawn target: one full shared-nothing service replica.

    Builds + warms its own CompressionService from the picklable
    ServiceConfig on the config's `device` (own model, own codec, own
    entropy stage; no native build after the warmup, as in every
    service), starts its own /healthz endpoint (metrics_port=0 ->
    ephemeral), and answers the ready handshake with its pid, healthz
    port, params digest, the warmup's `builds` and `seconds`, and
    `builds_at_ready` (`native_build.build_count()` the moment it is
    warm: a later reading minus it is the builds in steady state). Then:
    one reader loop (submit requests, answer via future callbacks
    through a single sender thread so pipe writes never interleave and
    never run under a lock) until "stop" or router death (EOF), then a
    graceful drain.

    `lanes` (shm transport) carries the manifests of the two lane rings
    the ROUTER created for this replica: requests arrive as LaneRef
    descriptors resolved (and freed) here, and the sender thread — the
    sole allocator of the result ring — lanes big "ok" payloads back.
    The child only attaches; the router owns segment lifetime."""
    from dsin_tpu_torch.serve.service import CompressionService
    req_ring = res_ring = None
    try:
        if lanes is not None:
            req_ring = shmlane.LaneRing.attach(lanes["req"])
            res_ring = shmlane.LaneRing.attach(lanes["res"])
        cfg = replace(config, metrics_port=0)
        service = CompressionService(cfg).start()
        warm = service.warmup()
        info = {"replica": replica_id, "pid": os.getpid(),
                "healthz_port": service.metrics_port,
                "device": str(service.device),
                "warmup_builds": warm["builds"],
                "warmup_s": warm["seconds"],
                "builds_at_ready": native_build.build_count(),
                # the service's bundle digest IS coding/loader.py
                # params_digest of the served model
                "params_digest": service.model_digest}
        if res_ring is not None:
            res_ring.set_metrics(service.metrics)
    except BaseException as e:  # noqa: BLE001 — the router needs the cause
        try:
            conn.send(("failed", replica_id, _picklable_exc(e)))
        finally:
            conn.close()
            for ring in (req_ring, res_ring):
                if ring is not None:
                    ring.close()
        return
    outq: "queue.Queue" = queue.Queue()

    def _sender():
        # the ONE result-ring allocator: laning happens here, on a
        # single thread, so "ok" payloads never race for lanes and a
        # pipe death can still free what it just claimed
        while True:
            item = outq.get()
            if item is None:
                return
            wire = None
            if res_ring is not None and item[0] == "ok":
                wire = protocol.wire_payload(res_ring, item[2])
                item = (item[0], item[1], wire)
            try:
                conn.send(item)
            except (OSError, ValueError, BrokenPipeError):
                if isinstance(wire, shmlane.LaneRef):
                    res_ring.free(wire)
                return     # router gone; the reader will see EOF too

    sender = threading.Thread(target=_sender, daemon=True,
                              name=f"replica-{replica_id}-send")
    sender.start()
    outq.put(("ready", replica_id, info))

    def _complete(rid, fut):
        exc = fut.exception(timeout=0)
        if exc is None:
            outq.put(("ok", rid, fut.result(timeout=0)))
        else:
            outq.put(("err", rid, _picklable_exc(exc)))

    def _run_control(op, rid, payload):
        """One hot-swap phase against this replica's service; the
        outcome (or its typed error — ManifestMismatch, SwapError)
        crosses the pipe like any response."""
        try:
            if op == "swap_prepare":
                ckpt, canary = protocol.parse_prepare(payload)
                res = service.prepare_swap(ckpt, canary=canary)
            elif op == "swap_commit":
                res = service.commit_swap(expect_digest=payload)
            elif op == "swap_abort":
                res = service.abort_swap()
            else:                            # "rollback"
                # payload = digest to roll AWAY from (conditional, the
                # fleet commit-failure recovery) or None (operator)
                res = service.rollback(expect_current=payload)
            outq.put(("ok", rid, res))
        except BaseException as e:  # noqa: BLE001 — router needs the cause
            outq.put(("err", rid, _picklable_exc(e)))

    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break              # router died: drain and exit
            if msg[0] == protocol.STOP:
                break
            # request messages carry a 6th element (the
            # front-door TraceContext); control ops stay 5-tuples
            op, rid, payload, priority, deadline_ms, trace = \
                protocol.parse_request(msg)
            try:
                # identity for inline payloads; a LaneRef copies out of
                # the request ring (CRC-verified) and frees the lane —
                # the receiver-frees half of the lane contract
                payload = protocol.resolve_payload(req_ring, payload)
            except (ValueError, shmlane.ShmLaneError) as e:
                # IntegrityError (corrupt lane / geometry liar) or a
                # descriptor with no ring: answer typed, keep serving
                outq.put(("err", rid, _picklable_exc(e)))
                continue
            if op in CONTROL_OPS:
                if op == "swap_prepare":
                    # prepare is the slow phase (load + warm):
                    # run it OFF the recv loop so requests keep flowing
                    # — the zero-downtime half of the contract. The
                    # service's own claim flag serializes overlapping
                    # prepares (the second fails typed).
                    threading.Thread(
                        target=_run_control, args=(op, rid, payload),
                        name=f"replica-{replica_id}-swap",
                        daemon=True).start()
                else:
                    # commit/abort/rollback are O(1) pointer swaps —
                    # inline keeps them ordered with request intake
                    _run_control(op, rid, payload)
                continue
            if op in ("session_open", "session_close"):
                # session control. close is an O(1) store
                # evict — inline. open runs the per-bucket prep
                # on the device (AE reconstruction of the side image +
                # device upload — real device time at big buckets), so
                # it runs OFF the recv loop like swap_prepare: request
                # intake must not head-of-line block behind a session
                # registration. A failure (over-capacity, bad shape)
                # crosses the pipe typed like any response.
                def _session_ctl(op_=op, rid_=rid, payload_=payload):
                    try:
                        res = (service.open_session(payload_)
                               if op_ == "session_open"
                               else service.close_session(payload_))
                    except BaseException as e:  # noqa: BLE001 — typed
                        outq.put(("err", rid_, _picklable_exc(e)))
                    else:
                        outq.put(("ok", rid_, res))
                if op == "session_open":
                    threading.Thread(
                        target=_session_ctl,
                        name=f"replica-{replica_id}-session",
                        daemon=True).start()
                else:
                    _session_ctl()
                continue
            try:
                if op == "encode":
                    fut = service.submit_encode(
                        payload, deadline_ms=deadline_ms,
                        priority=priority, trace=trace)
                elif op == "decode":
                    fut = service.submit_decode(
                        payload, deadline_ms=deadline_ms,
                        priority=priority, trace=trace)
                elif op == "decode_si":
                    fut = service.submit_decode_si(
                        payload[0], payload[1], deadline_ms=deadline_ms,
                        priority=priority, trace=trace)
                else:
                    raise ValueError(f"unknown replica op {op!r}")
            except BaseException as e:  # noqa: BLE001 — typed door rejects
                outq.put(("err", rid, _picklable_exc(e)))
                continue
            fut.add_done_callback(
                lambda f, rid=rid: _complete(rid, f))
    finally:
        service.drain()
        # "bye" goes through the sender queue like every other message:
        # a main-thread conn.send here could interleave with an
        # in-progress sender write and corrupt the stream
        outq.put(("bye", replica_id, None))
        outq.put(None)
        sender.join(timeout=10)
        if not sender.is_alive():
            conn.close()
            # close (never unlink — the router owns the segments) only
            # once the sender cannot be mid-write into a lane
            for ring in (req_ring, res_ring):
                if ring is not None:
                    ring.close()
        # a wedged sender keeps the fd — closing under its write would
        # be the same interleaving; process exit reclaims it


def _spawn_launcher(config, idx: int, ctx, lanes=None):
    """Default replica launcher: a real spawn process + duplex pipe
    (spawn, never fork: the parent may hold a CUDA context).
    Tests substitute a launcher whose far end is driven in-process.
    `lanes` (shm transport) is the picklable {req, res} ring-manifest
    pair the child attaches to."""
    parent, child = ctx.Pipe(duplex=True)
    proc = ctx.Process(target=_replica_main,
                       args=(child, config, idx, lanes),
                       name=f"serve-replica-{idx}", daemon=True)
    proc.start()
    child.close()
    return proc, parent


# -- router (parent) ----------------------------------------------------------

class _Pending:
    """One routed request: everything needed to re-dispatch it if its
    replica dies mid-flight (encode/decode are pure — a retry is
    safe), plus the caller's future. Exactly-once resolution is owned
    by whoever pops it from an in-flight map. The deadline is pinned
    ABSOLUTE at intake (`expires_at`) so a reroute forwards only the
    REMAINING budget instead of restarting the clock. `trace` is the
    front-door TraceContext that crosses the pipe with every
    (re)dispatch — a rerouted request keeps its trace id."""

    __slots__ = ("op", "payload", "priority", "expires_at", "future",
                 "retries", "trace")

    def __init__(self, op, payload, priority, deadline_ms, retries,
                 trace=None):
        self.op = op
        self.payload = payload
        self.priority = priority
        self.expires_at = (None if deadline_ms is None
                           else time.monotonic() + deadline_ms / 1000.0)
        self.future = Future()
        self.future.trace = trace
        self.retries = retries
        self.trace = trace

    def remaining_ms(self) -> Optional[float]:
        """Budget left right now; None = no deadline, <= 0 = expired."""
        if self.expires_at is None:
            return None
        return (self.expires_at - time.monotonic()) * 1000.0


class _Replica:
    """Parent-side replica handle: process, pipe, and the in-flight map
    (rid -> _Pending) under the per-replica lock, which
    also serializes pipe sends (interleaved Connection writes corrupt
    the stream). With the shm transport, `rings` holds the two lane
    rings the ROUTER created for this replica ("req": router allocates,
    child frees; "res": child's sender allocates, router's reader
    frees) — created before spawn, unlinked exactly once when the
    replica leaves for good."""

    __slots__ = ("idx", "proc", "conn", "info", "lock", "inflight",
                 "reader", "rings")

    def __init__(self, idx: int, proc, conn, rings=None):
        self.idx = idx
        self.proc = proc
        self.conn = conn
        self.info: Optional[dict] = None
        self.lock = threading.Lock()
        self.inflight: Dict[int, _Pending] = {}   # guarded-by: self.lock
        self.reader: Optional[threading.Thread] = None
        self.rings: Optional[Dict[str, shmlane.LaneRing]] = rings

    def ring(self, which: str) -> Optional[shmlane.LaneRing]:
        rings = self.rings
        return None if rings is None else rings.get(which)

    def close_rings(self) -> None:
        """Unlink both segments (idempotent; creator side only — the
        router created them). Attached children keep valid mappings
        until they close; the NAME disappears now, so a /dev/shm census
        goes clean the moment the replica leaves the rotation."""
        rings, self.rings = self.rings, None
        if rings:
            for ring in rings.values():
                ring.unlink()


class FrontDoorRouter:
    """N shared-nothing service replicas behind one in-process front
    door: admission gate -> per-class round-robin -> replica pipe.

    Lifecycle: start() (spawns + waits for every ready handshake,
    refuses digest mismatches) -> submit_encode/submit_decode/encode/
    decode -> drain(). `launcher(config, idx, ctx) -> (proc|None, conn)`
    is injectable for tests (fake replicas driven in-process)."""

    def __init__(self, config, replicas: int = 2,
                 admission_limits: Optional[Mapping[str, int]] = None,
                 poll_every_s: float = 0.25, evict_after: int = 2,
                 death_retries: int = 1, health_timeout_s: float = 2.0,
                 start_timeout_s: float = 600.0, launcher=None,
                 metrics_port: Optional[int] = None,
                 trace_sample_rate: float = 0.0,
                 trace_capacity: int = 4096,
                 flight_dir: Optional[str] = None,
                 transport: Optional[str] = None,
                 prewarm_template: bool = False,
                 shm_lanes_per_class: Optional[int] = None):
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        if evict_after < 1:
            raise ValueError(f"evict_after must be >= 1, got {evict_after}")
        # router->replica payload transport: None inherits the config's
        # (which governs the service->entropy-pool hop the same way)
        self.transport = (transport if transport is not None
                          else getattr(config, "transport", "pipe"))
        if self.transport not in ("pipe", "shm"):
            raise ValueError(
                f"transport must be 'pipe' or 'shm', "
                f"got {self.transport!r}")
        self._shm_lanes_per_class = shm_lanes_per_class
        self.config = config
        self.num_replicas = int(replicas)
        self.poll_every_s = float(poll_every_s)
        self.evict_after = int(evict_after)
        self.death_retries = int(death_retries)
        self.health_timeout_s = float(health_timeout_s)
        self.start_timeout_s = float(start_timeout_s)
        self.metrics = metrics_lib.MetricsRegistry()
        classes = getattr(config, "priority_classes", None)
        self._class_names: List[str] = (
            [pc.name for pc in classes] if classes else ["default"])
        # class default deadlines resolve HERE, at the front door, so a
        # reroute off a dead replica spends the remaining budget rather
        # than letting the replacement replica restart the default clock
        self._default_deadline_ms: Dict[str, Optional[float]] = (
            {pc.name: pc.default_deadline_ms for pc in classes}
            if classes else {})
        if admission_limits is None:
            # default: every replica can hold a full class queue plus
            # its pipelines in flight (shared derivation with the
            # service's own gate) — the cap is on the AGGREGATE
            # backlog, and it RESCALES with the live fleet (an
            # add/drain/death re-derive it; an operator-given explicit
            # map never moves)
            self._admission_per_replica: Optional[Dict[str, int]] = \
                dict(default_admission_limits(config))
            admission_limits = {
                c: self.num_replicas * per_replica
                for c, per_replica in
                self._admission_per_replica.items()}
        else:
            self._admission_per_replica = None
        self.admission = AdmissionController(admission_limits,
                                             metrics=self.metrics)
        self._launcher = launcher or _spawn_launcher
        self._lock = threading.Lock()
        # APPEND-ONLY at runtime: a drained/dead replica
        # keeps its slot (its idx stays a stable key for pins, metrics,
        # per-replica info) in a terminal state; add_replica appends.
        self._replicas: List[_Replica] = []   # guarded-by: self._lock
        self._state: Dict[int, str] = {}   # guarded-by: self._lock
        self._fails: Dict[int, int] = {}   # guarded-by: self._lock
        self._rr: Dict[str, int] = {}      # guarded-by: self._lock
        self._rid = 0                      # guarded-by: self._lock
        # one runtime scale op (add/drain) at a time; also excludes
        # fleet swaps (a replica admitted mid-commit could land on
        # either side of the digest)
        self._scaling = False              # guarded-by: self._lock
        # sid -> replica idx: the session-affinity pin table
        self._sessions: Dict[str, int] = {}  # guarded-by: self._lock
        self._stop = threading.Event()
        self._poller: Optional[threading.Thread] = None
        self._started = False
        self.params_digest: Optional[str] = None
        self._swapping = False             # guarded-by: self._lock
        # set = dispatch flows; cleared only for the fleet COMMIT window
        # (O(1) per replica), so "the fleet serves two models at once"
        # has no dispatch to land in. Fail-open after a bounded wait.
        self._swap_gate = threading.Event()
        self._swap_gate.set()
        self.metrics_port = metrics_port
        self._metrics_server: Optional[metrics_lib.MetricsServer] = None
        #: the fleet-merged metrics view (the one-endpoint aggregation);
        #: usable directly (`.snapshot()`) or served via `metrics_port`
        self.aggregate = AggregatedMetrics(self)
        # observability: the router mints the FRONT-DOOR
        # trace context (its head sampling decision rides the pipe and
        # is honored by the replica), records the router.dispatch span,
        # and keeps its own flight ring (sheds, replica deaths)
        self.tracer = trace_lib.Tracer(
            sample_rate=trace_sample_rate, capacity=trace_capacity,
            metrics=self.metrics)
        self.flight = trace_lib.FlightRecorder(
            dump_dir=flight_dir, metrics=self.metrics)
        #: the fleet-merged trace view: the router's own spans + a live
        #: /trace scrape of every replica, stitched onto one timeline
        self.traces = AggregatedTraces(self)
        # pre-warmed replica template (cold-start attack): one paused,
        # warmed spawn held in reserve OUTSIDE the rotation (no
        # reader thread — nothing routes to it), so add_replica becomes
        # digest-handshake + unpause. Stock/admit/discard run under the
        # template lock (taken BEFORE the frontdoor lock, never
        # under it: admit walks into the replica-table machinery).
        self._template_enabled = bool(prewarm_template)
        self._template_lock = threading.Lock()
        # both guarded-by: self._template_lock
        self._template: Optional[_Replica] = None
        self._template_thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def _lane_classes(self) -> List[shmlane.LaneClass]:
        """Ring geometry for ONE replica direction: a lane class per
        bucket (sized for the widest payload a bucket produces —
        float32 HxWx3 plus pickle slack) and a small class for the
        blobs between the inline threshold and the smallest bucket.
        Oversize falls back inline by contract, so the bound only has
        to be right for the common case, not a guarantee."""
        per = self._shm_lanes_per_class
        if per is None:
            per = min(16, max(4, self.config.max_batch
                              * max(1, self.config.workers)
                              * max(1, self.config.pipeline_depth)))
        bounds = [("small", shmlane.SMALL_INLINE_MAX * 4)]
        for (bh, bw) in self.config.buckets:
            bounds.append((f"b{bh}x{bw}", bh * bw * 3 * 4 + 65536))
        return shmlane.derive_lane_classes(bounds, per)

    def _launch(self, idx: int, ctx, tag: str = "") -> _Replica:
        """Launch one replica through the injectable launcher. With the
        shm transport the router creates the replica's two lane rings
        FIRST (it owns segment lifetime end to end — one process to
        blame for a /dev/shm leak) and ships their manifests to the
        child, which only attaches."""
        if self.transport != "shm":
            proc, conn = self._launcher(self.config, idx, ctx)
            return _Replica(idx, proc, conn)
        classes = self._lane_classes()
        rings = {
            "req": shmlane.LaneRing.create(f"{tag}r{idx}q", classes,
                                           metrics=self.metrics),
            "res": shmlane.LaneRing.create(f"{tag}r{idx}s", classes,
                                           metrics=self.metrics),
        }
        # the fallback contract is typed + counted + FLIGHT-RECORDED:
        # the counter says how often, the timeline says when and why
        rings["req"].on_fallback = (
            lambda reason, size, _idx=idx: self.flight.record(
                "shm_fallback", replica=_idx, reason=reason,
                payload_bytes=size))
        try:
            proc, conn = self._launcher(
                self.config, idx, ctx,
                lanes={"req": rings["req"].manifest(),
                       "res": rings["res"].manifest()})
        except BaseException:
            for ring in rings.values():
                ring.unlink()
            raise
        return _Replica(idx, proc, conn, rings=rings)

    def start(self) -> "FrontDoorRouter":
        if self._started:
            return self
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        replicas = []
        for i in range(self.num_replicas):
            replicas.append(self._launch(i, ctx))
        with self._lock:
            self._replicas = replicas
        deadline = time.monotonic() + self.start_timeout_s
        digests = []
        try:
            for rep in replicas:
                rep.info = self._wait_ready(rep, deadline)
                digests.append(rep.info.get("params_digest"))
        except BaseException:
            self._kill_all()
            raise
        if len(set(digests)) > 1:
            self._kill_all()
            raise RuntimeError(
                f"replicas built DIFFERENT models (params digests "
                f"{digests}) — refusing a fleet whose members would "
                f"answer the same request with different bytes")
        self.params_digest = digests[0]
        with self._lock:
            for rep in replicas:
                self._state[rep.idx] = "live"
                self._fails[rep.idx] = 0
        for rep in replicas:
            rep.reader = threading.Thread(
                target=self._reader, args=(rep,),
                name=f"router-reader-{rep.idx}", daemon=True)
            rep.reader.start()
        self._poller = threading.Thread(target=self._poll_loop,
                                        name="router-health", daemon=True)
        self._poller.start()
        self._publish_replica_gauges()
        if self.metrics_port is not None:
            self._metrics_server = metrics_lib.MetricsServer(
                self.aggregate, self.health,
                port=self.metrics_port,
                trace=self.traces.http_snapshot).start()
        self._started = True
        self._kick_restock()
        return self

    def _all_replicas(self) -> List[_Replica]:
        """Snapshot of the replica list (append-only, but iterating the
        live list while add_replica appends is still a data race)."""
        with self._lock:
            return list(self._replicas)

    def _publish_replica_gauges(self) -> None:
        with self._lock:
            states = [self._state.get(rep.idx) for rep in self._replicas]
            live = sum(1 for s in states if s == "live")
            if self._admission_per_replica is not None:
                # the aggregate admission cap tracks the LIVE fleet: a
                # scaled-up fleet behind the old cap would shed exactly
                # the load the scale-up was meant to absorb. Applied
                # UNDER the frontdoor lock (the admission lock is a leaf)
                # so two concurrent publishers cannot apply stale live
                # counts last-writer-wins.
                self.admission.set_limits(
                    {c: max(1, live) * per for c, per in
                     self._admission_per_replica.items()})
            # gauges too: publishes only happen on scale/death events,
            # so a last-writer-wins stale count would stand until the
            # NEXT fleet mutation
            self.metrics.gauge("serve_router_replicas").set(live)
            self.metrics.gauge("serve_router_replicas_total").set(
                len(states))

    def _wait_ready(self, rep: _Replica, deadline: float,
                    abort_on_stop: bool = False) -> dict:
        while True:
            if abort_on_stop and self._stop.is_set():
                raise RuntimeError(
                    "router is draining — abandoning replica startup")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"replica {rep.idx} not ready within "
                    f"{self.start_timeout_s}s")
            try:
                if rep.conn.poll(min(remaining, 0.5)):
                    tag, _idx, payload = rep.conn.recv()
                    if tag == "ready":
                        return payload
                    if tag == "failed":
                        raise RuntimeError(
                            f"replica {rep.idx} failed to start"
                            ) from payload
                    continue
            except EOFError:
                raise RuntimeError(
                    f"replica {rep.idx} died during startup") from None
            if rep.proc is not None and not rep.proc.is_alive():
                raise RuntimeError(
                    f"replica {rep.idx} exited (code "
                    f"{rep.proc.exitcode}) during startup")

    def _kill_all(self) -> None:
        for rep in self._all_replicas():
            if rep.proc is not None and rep.proc.is_alive():
                rep.proc.terminate()
            try:
                rep.conn.close()
            except OSError:
                pass
            rep.close_rings()

    def __enter__(self) -> "FrontDoorRouter":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.drain()

    # -- intake -------------------------------------------------------------

    # NOTE: parameter order mirrors CompressionService.submit_* /
    # encode/decode exactly — the router is a drop-in front door, so
    # positional calls written against one must mean the same thing
    # against the other.

    # contract: request-path — every reachable raise must be a typed error
    def submit_encode(self, img, deadline_ms: Optional[float] = None,
                      priority: Optional[str] = None,
                      trace=None) -> Future:
        return self._submit("encode", img, priority, deadline_ms,
                            trace=trace)

    # contract: request-path — every reachable raise must be a typed error
    def submit_decode(self, blob: bytes,
                      deadline_ms: Optional[float] = None,
                      priority: Optional[str] = None,
                      trace=None) -> Future:
        return self._submit("decode", blob, priority, deadline_ms,
                            trace=trace)

    def encode(self, img, deadline_ms: Optional[float] = None,
               timeout: Optional[float] = 120.0,
               priority: Optional[str] = None):
        return self.submit_encode(img, deadline_ms,
                                  priority=priority).result(timeout)

    def decode(self, blob: bytes, deadline_ms: Optional[float] = None,
               timeout: Optional[float] = 120.0,
               priority: Optional[str] = None):
        return self.submit_decode(blob, deadline_ms,
                                  priority=priority).result(timeout)

    def _submit(self, op: str, payload, priority: Optional[str],
                deadline_ms: Optional[float], trace=None) -> Future:
        assert self._started, "start() the router before submitting"
        cls = priority or self._class_names[0]
        try:
            self.admission.admit(cls)   # sheds HERE, before any enqueue
        except ServiceOverloaded:
            self.flight.record("shed", reason="admission", cls=cls)
            raise
        if deadline_ms is None:
            deadline_ms = self._default_deadline_ms.get(cls)
        # an externally-minted context (another tier)
        # rides through unchanged — its head sampling decision already
        # happened, so one trace id stitches across both router tiers
        pending = _Pending(op, payload, cls, deadline_ms,
                           self.death_retries,
                           trace=(trace if trace is not None else
                                  self.tracer.mint(origin="router")))
        self.admission.attach(cls, pending.future)
        self._attach_trace(pending, op, cls)
        try:
            self._dispatch(pending)
        except ServiceUnavailable as e:
            # resolve the (admission-attached) future so the slot frees,
            # then still raise at the door like the single-process path
            pending.future.set_exception(e)
            raise
        self.metrics.counter(f"serve_router_routed_{cls}").inc()
        return pending.future

    def _attach_trace(self, pending: _Pending, op: str,
                      cls: str) -> None:
        """Router-hop observability: the router.dispatch
        span covers front-door intake -> future resolution (reroutes
        included — it is the caller-visible hop), and a typed-error
        resolution records into the router's flight ring like the
        service's own callback does replica-side."""
        ctx = pending.trace
        t0 = time.monotonic()

        def _resolved(fut):
            exc = fut.exception(timeout=0)
            self.tracer.span_for(ctx, trace_lib.SPAN_ROUTER, t0,
                                 time.monotonic(), op=op, cls=cls)
            if exc is not None and isinstance(exc, (ServeError,
                                                    ValueError)):
                self.tracer.error(ctx, exc)
                self.flight.note_error(
                    exc, trace_id=ctx.trace_id if ctx else None)

        pending.future.add_done_callback(_resolved)

    # -- side-information sessions --------------------------------

    def _send_pinned(self, rep: _Replica, op: str,
                     pending: _Pending) -> bool:
        """Targeted send to a SPECIFIC replica (no re-pick on failure —
        session state lives only there). Returns False when the pipe is
        already gone; the caller owns the typed answer."""
        with self._lock:
            rid = self._next_rid_locked()
        # lane the payload OUTSIDE rep.lock (pickling a side image under
        # the send lock would serialize it against every other send)
        ring = rep.ring("req")
        wire = protocol.wire_payload(ring, pending.payload)
        with rep.lock:
            rep.inflight[rid] = pending
            try:
                rep.conn.send(protocol.request_msg(
                    op, rid, wire, pending.priority,
                    pending.remaining_ms(), pending.trace))
                return True
            except (OSError, ValueError, BrokenPipeError):
                del rep.inflight[rid]
        if isinstance(wire, shmlane.LaneRef):
            ring.free(wire)   # nobody will ever take it
        return False

    def _publish_pins(self) -> None:
        with self._lock:
            n = len(self._sessions)
        self.metrics.gauge("serve_router_sessions_pinned").set(n)

    def _drop_all_pins(self, reason: str) -> None:
        """Flush the whole pin table — every replica just invalidated
        its session store (a fleet swap commit or rollback), so every
        pin is stale: answering SessionExpired at the door beats paying
        a replica round trip to learn the same thing, and a long-lived
        router must not leak pins across model versions."""
        with self._lock:
            n = len(self._sessions)
            self._sessions.clear()
        if n:
            self.metrics.counter(
                f"serve_router_sessions_dropped_{reason}").inc(n)
        self._publish_pins()

    def open_session(self, side_img,
                     timeout: Optional[float] = 120.0) -> str:
        """Register a side image on ONE replica and pin the session to
        it: round-robin over live replicas at open time, then every
        decode_si for the returned sid routes there. A replica-side
        refusal (SessionOverCapacity, bad shape) raises typed here.

        A reply that times out AFTER the replica registered the prep
        leaves that prep unpinned on the replica (the router never
        learned its sid). That slot is not leaked forever — the store's
        LRU bound reclaims it under pressure and `session_ttl_s` ages it
        out — but deployments relying on opens-under-timeout should run
        with a TTL configured."""
        assert self._started, "start() the router before opening sessions"
        for _ in range(self.num_replicas):
            picked = self._pick("_session")
            if picked is None:
                break
            rep, _rid = picked
            pending = _Pending("session_open", side_img, "control",
                               None, 0)
            if not self._send_pinned(rep, "session_open", pending):
                self._on_disconnect(rep)
                continue
            sid = pending.future.result(timeout)
            with self._lock:
                self._sessions[sid] = rep.idx
            self.metrics.counter("serve_router_sessions_opened").inc()
            self._publish_pins()
            return sid
        raise ServiceUnavailable(
            f"no live replica to open a session on "
            f"({self.num_replicas} configured) — retry shortly")

    def close_session(self, session_id: str,
                      timeout: Optional[float] = 30.0) -> bool:
        """Unpin + free a session; False if it was already gone."""
        assert self._started, "start() the router first"
        with self._lock:
            idx = self._sessions.pop(session_id, None)
            rep = None if idx is None else self._replicas[idx]
        self._publish_pins()
        if rep is None:
            return False
        pending = _Pending("session_close", session_id, "control", None, 0)
        if not self._send_pinned(rep, "session_close", pending):
            self._on_disconnect(rep)
            return False    # replica gone: its store died with it
        try:
            return bool(pending.future.result(timeout))
        except Exception:   # noqa: BLE001 — the pin is dropped either way
            return False

    # contract: request-path — every reachable raise must be a typed error
    def submit_decode_si(self, blob: bytes, session_id: str,
                         deadline_ms: Optional[float] = None,
                         priority: Optional[str] = None,
                         trace=None) -> Future:
        """SI decode against a pinned session. An unknown pin, an
        evicted/dead pinned replica, or the replica dying mid-flight
        all answer typed `SessionExpired` — the prep existed in exactly
        one process, so 're-open the session' is the only recovery."""
        assert self._started, "start() the router before submitting"
        with self._lock:
            idx = self._sessions.get(session_id)
            state = None if idx is None else self._state.get(idx)
        if idx is None or state != "live":
            raise SessionExpired(
                f"session {session_id!r} is not pinned to a live replica "
                f"(never opened, closed, or its replica "
                f"{'died' if idx is not None else 'is unknown'}) — "
                f"re-open it")
        cls = priority or self._class_names[0]
        try:
            self.admission.admit(cls)   # sheds HERE, before any enqueue
        except ServiceOverloaded:
            self.flight.record("shed", reason="admission", cls=cls)
            raise
        if deadline_ms is None:
            deadline_ms = self._default_deadline_ms.get(cls)
        pending = _Pending("decode_si", (blob, session_id), cls,
                           deadline_ms, 0,
                           trace=(trace if trace is not None else
                                  self.tracer.mint(origin="router")))
        self.admission.attach(cls, pending.future)
        self._attach_trace(pending, "decode_si", cls)
        self._swap_gate.wait(_SWAP_GATE_TIMEOUT_S)
        with self._lock:
            rep = self._replicas[idx]
        if not self._send_pinned(rep, "decode_si", pending):
            self._on_disconnect(rep)
            exc = SessionExpired(
                f"session {session_id!r}'s replica {idx} is gone — "
                f"its prep died with it; re-open the session")
            pending.future.set_exception(exc)
            raise exc
        self.metrics.counter(f"serve_router_routed_{cls}").inc()
        self.metrics.counter(f"serve_router_routed_r{rep.idx}").inc()
        return pending.future

    def decode_si(self, blob: bytes, session_id: str,
                  deadline_ms: Optional[float] = None,
                  timeout: Optional[float] = 120.0,
                  priority: Optional[str] = None):
        return self.submit_decode_si(blob, session_id, deadline_ms,
                                     priority=priority).result(timeout)

    # -- routing ------------------------------------------------------------

    def _next_rid_locked(self) -> int:
        self._rid += 1
        return self._rid

    def _pick(self, cls: str) -> Optional[Tuple[_Replica, int]]:
        with self._lock:
            live = [rep for rep in self._replicas
                    if self._state[rep.idx] == "live"]
            if not live:
                return None
            i = self._rr.get(cls, 0)
            self._rr[cls] = i + 1
            return live[i % len(live)], self._next_rid_locked()

    def _dispatch(self, pending: _Pending) -> None:
        """Route to the class's next live replica; a send that discovers
        a dead pipe marks the replica and moves on. Raises typed
        ServiceUnavailable when no live replica accepts the send.
        Briefly parks on the swap gate during a fleet commit (the
        never-two-models window), failing OPEN after a bounded wait."""
        self._swap_gate.wait(_SWAP_GATE_TIMEOUT_S)
        for _ in range(self.num_replicas):
            picked = self._pick(pending.priority)
            if picked is None:
                break
            rep, rid = picked
            sent = False
            # lane the payload per-TARGET (a reroute re-encodes on the
            # new replica's ring — _Pending keeps the original object,
            # never a descriptor), outside rep.lock
            ring = rep.ring("req")
            wire = protocol.wire_payload(ring, pending.payload)
            with rep.lock:
                rep.inflight[rid] = pending
                try:
                    # forward the REMAINING budget: on a reroute the
                    # replacement replica must not restart the clock
                    # (the trace context rides every (re)dispatch, so
                    # a rerouted request keeps one stitched timeline)
                    rep.conn.send(protocol.request_msg(
                        pending.op, rid, wire, pending.priority,
                        pending.remaining_ms(), pending.trace))
                    sent = True
                except (OSError, ValueError, BrokenPipeError):
                    del rep.inflight[rid]
            if not sent and isinstance(wire, shmlane.LaneRef):
                ring.free(wire)   # nobody will ever take it
            if sent:
                self.metrics.counter(
                    f"serve_router_routed_r{rep.idx}").inc()
                return
            self._on_disconnect(rep)
        raise ServiceUnavailable(
            f"no live replica for class {pending.priority!r} "
            f"({self.num_replicas} configured) — retry shortly")

    def _reader(self, rep: _Replica) -> None:
        """Per-replica response pump. EOF (or 'bye') means the replica
        is gone — its in-flight work reroutes."""
        while True:
            try:
                msg = rep.conn.recv()
            except (EOFError, OSError):
                break
            tag = msg[0]
            if tag == "bye":
                break
            if tag not in ("ok", "err"):
                continue
            _tag, rid, payload = msg
            with rep.lock:
                pending = rep.inflight.pop(rid, None)
            if pending is None:
                continue   # already rerouted by a death race: drop, the
                #            live dispatch owns the future now
            if tag == "ok":
                try:
                    # identity for inline results; a LaneRef copies out
                    # of the result ring (CRC-verified) and frees the
                    # lane. A corrupt lane answers TYPED — the caller
                    # gets IntegrityError, never plausible wrong bytes.
                    payload = protocol.resolve_payload(
                        rep.ring("res"), payload)
                except (ValueError, shmlane.ShmLaneError) as e:
                    self.metrics.counter(
                        "serve_shm_integrity_errors").inc()
                    self.flight.record("shm_integrity", replica=rep.idx,
                                       error=f"{type(e).__name__}: {e}")
                    pending.future.set_exception(e)
                    continue
                pending.future.set_result(payload)
            else:
                if isinstance(payload, DeadlineExceeded):
                    self.metrics.counter(
                        f"serve_router_expired_{pending.priority}").inc()
                pending.future.set_exception(payload)
        self._on_disconnect(rep)

    def _on_disconnect(self, rep: _Replica) -> None:
        """Transport loss: classify it and run the ONE leave-rotation
        path. Only a replica that was already TOLD to stop
        ('stopping', or terminal 'drained') leaves as a graceful
        drain; EOF while merely 'draining' (the in-flight grace
        window, before the stop was sent) is a real crash — it must
        count as a death and trigger the flight dump."""
        with self._lock:
            reason = ("drain"
                      if self._state.get(rep.idx) in ("stopping",
                                                      "drained")
                      else "death")
        self._leave_rotation(rep, reason=reason)

    def _leave_rotation(self, rep: _Replica, *, reason: str) -> None:
        """THE one path a replica leaves the rotation by — crash/EOF
        ('death') and graceful scale-down ('drain') share it end to end
        (the two used to be separate code, so pin
        orphaning and in-flight handling could drift). First observer
        marks the terminal state and owns the cleanup (idempotent:
        later observers find it terminal and an empty map); session
        pins drop with `serve_router_session_orphans` accounting and
        in-flight requests resolve exactly once — rerouted, expired, or
        typed — identically in both paths. Futures resolve exactly
        once: ownership transfers by popping from the in-flight map."""
        terminal = "drained" if reason == "drain" else "dead"
        with self._lock:
            already = self._state.get(rep.idx) in ("dead", "drained")
            self._state[rep.idx] = terminal
        if already:
            return
        draining = self._stop.is_set()
        if not draining:
            if reason == "drain":
                # graceful exits are flight events, not deaths: the
                # scaler's own decision trail must not read as crashes
                self.flight.record("scale_down", replica=rep.idx)
            else:
                self.metrics.counter("serve_router_replica_deaths").inc()
                # replica death is a flight-dump trigger:
                # the router's ring holds the routing/shed decisions
                # that led up to it
                self.flight.note_death("replica_death", replica=rep.idx)
        # drop the replica's session pins FIRST: a submit racing this
        # exit must find no pin (typed SessionExpired at the door),
        # never a pin pointing at a corpse/drained store
        with self._lock:
            orphan_sids = [sid for sid, i in self._sessions.items()
                           if i == rep.idx]
            for sid in orphan_sids:
                del self._sessions[sid]
        if orphan_sids and not draining:
            self.metrics.counter("serve_router_session_orphans").inc(
                len(orphan_sids))
        self._publish_pins()
        with rep.lock:
            orphans = list(rep.inflight.items())
            rep.inflight.clear()
        for _rid, pending in orphans:
            if pending.future.done():
                continue
            if pending.op == "decode_si":
                # the session's prep lived only in the departed replica
                # — rerouting would hit a store that never heard of it;
                # fail typed with the one recovery that works
                pending.future.set_exception(SessionExpired(
                    f"replica {rep.idx} left the rotation ({reason}) "
                    f"holding this SI request — its session's prep "
                    f"went with it; re-open the session"))
                continue
            if pending.op in CONTROL_OPS:
                # a swap phase is pinned to ITS replica — rerouting a
                # prepare/commit to a different process would corrupt
                # the two-phase bookkeeping; the coordinator (swap_model)
                # sees the typed failure and aborts the fleet
                pending.future.set_exception(ServiceUnavailable(
                    f"replica {rep.idx} died during {pending.op}"))
                continue
            rem = pending.remaining_ms()
            if rem is not None and rem <= 0.0:
                # budget spent while the dead replica held it: expire
                # typed instead of rerouting zombie work
                self.metrics.counter(
                    f"serve_router_expired_{pending.priority}").inc()
                pending.future.set_exception(DeadlineExceeded(
                    f"replica {rep.idx} died holding this request and "
                    f"its deadline has already passed (class "
                    f"{pending.priority!r})", priority=pending.priority))
                continue
            if pending.retries > 0 and not draining:
                pending.retries -= 1
                self.metrics.counter("serve_router_reroutes").inc()
                try:
                    self._dispatch(pending)
                    continue
                except ServiceUnavailable as e:
                    pending.future.set_exception(e)
                    continue
            pending.future.set_exception(ServiceUnavailable(
                f"replica {rep.idx} went away with this request in "
                f"flight" + ("" if draining else " (no retry left)")))
        # terminal exit owns the shm segments too: unlink NOW (death
        # never reaches _reap) so a /dev/shm census after any exit —
        # crash or drain — is clean. Idempotent with _reap's unlink.
        rep.close_rings()
        self._publish_replica_gauges()

    # -- pre-warmed replica template -------------------------------

    def _kick_restock(self) -> None:
        """Start a background stock of the template slot unless one is
        already running, one is already stocked, or the router is
        draining. Never blocks the caller on a spawn."""
        if not self._template_enabled or self._stop.is_set():
            return
        with self._template_lock:
            if self._template is not None:
                return
            t = self._template_thread
            if t is not None and t.is_alive():
                return
            self._template_thread = threading.Thread(
                target=self._stock_template, name="router-template",
                daemon=True)
            self._template_thread.start()
        self.metrics.counter("serve_template_restocks").inc()

    def _stock_template(self) -> None:
        """Background thread body: spawn + warm ONE reserve
        replica and park it OUTSIDE the rotation (no reader thread —
        it is paused: its service sits recv-blocked with zero traffic,
        model warm, shm lanes pre-mapped). Runs WITHOUT the scale
        claim: stocking for seconds must not block a drain; only the
        O(1) admit runs under add_replica's claim."""
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        rep = None
        try:
            with self._lock:
                idx = len(self._replicas)
            rep = self._launch(idx, ctx, tag="t")
            rep.info = self._wait_ready(
                rep, time.monotonic() + self.start_timeout_s,
                abort_on_stop=True)
        except BaseException as e:  # noqa: BLE001 — background, log+count
            if not self._stop.is_set():
                # a drain abort is a clean shutdown, not a stock failure
                self.metrics.counter("serve_template_failures").inc()
                self.flight.record("template_stock_failed",
                                   error=f"{type(e).__name__}: {e}")
            if rep is not None:
                self._reap(rep, timeout_s=5.0)
            return
        stale = None
        with self._template_lock:
            if self._stop.is_set() or self._template is not None:
                stale = rep    # drained while stocking / lost a race
            else:
                self._template = rep
        if stale is not None:
            self._reap(stale, stop_first=True, timeout_s=5.0)
            return
        self.metrics.gauge("serve_template_ready").set(1)
        self.flight.record("template_stocked",
                           digest=(rep.info or {}).get("params_digest"))

    def _take_template(self) -> Optional[_Replica]:
        with self._template_lock:
            rep, self._template = self._template, None
        if rep is not None:
            self.metrics.gauge("serve_template_ready").set(0)
        return rep

    def template_ready(self) -> bool:
        """True while a warmed reserve replica is stocked (the
        autoscale bench waits on this before timing the fast path)."""
        with self._template_lock:
            return self._template is not None

    def _discard_template(self, *, restock: bool) -> None:
        """Reap the stocked template (drain, or a fleet swap made its
        digest stale) and optionally stock a fresh one."""
        rep = self._take_template()
        if rep is not None:
            self._reap(rep, stop_first=True, timeout_s=5.0)
        if restock:
            self._kick_restock()

    def _revalidate_template(self) -> None:
        """After a fleet swap/rollback: a template warmed on the OLD
        digest can never be admitted (the admit handshake would refuse
        it) — discard it now and restock on the new model, instead of
        paying the miss at the next scale-up."""
        if not self._template_enabled:
            return
        with self._template_lock:
            rep = self._template
            digest = (rep.info or {}).get("params_digest") if rep else None
        if rep is not None and self.params_digest is not None \
                and digest != self.params_digest:
            self.metrics.counter("serve_template_stale").inc()
            self._discard_template(restock=True)

    def _admit_template(self, rep: _Replica) -> Optional[dict]:
        """The fast half of add_replica (caller holds the scale claim):
        digest handshake + unpause. The template already paid spawn +
        build + warm when it was stocked; admit is appending it
        to the rotation and starting its reader — O(ms). Returns None
        (template unusable: died in reserve, or its digest went stale)
        to fall through to the cold path."""
        info = rep.info or {}
        digest = info.get("params_digest")
        alive = rep.proc is None or rep.proc.is_alive()
        if not alive or (self.params_digest is not None
                         and digest != self.params_digest):
            self.metrics.counter("serve_template_misses").inc()
            if not alive:
                self.flight.record("template_miss", reason="dead")
            else:
                self.metrics.counter("serve_template_stale").inc()
                self.flight.record("template_miss", reason="digest",
                                   template_digest=digest,
                                   fleet_digest=self.params_digest)
            self._reap(rep, stop_first=alive, timeout_s=5.0)
            return None
        if self.params_digest is None:
            self.params_digest = digest
        with self._lock:
            idx = len(self._replicas)
            rep.idx = idx     # the child's provisional id is cosmetic:
            #                   the reader matches answers on rid
            rep.info = dict(info, replica=idx)
            self._replicas.append(rep)
            self.num_replicas = len(self._replicas)
            self._state[idx] = "live"
            self._fails[idx] = 0
        rep.reader = threading.Thread(
            target=self._reader, args=(rep,),
            name=f"router-reader-{idx}", daemon=True)
        rep.reader.start()
        self.metrics.counter("serve_router_scale_ups").inc()
        self.metrics.counter("serve_template_admits").inc()
        self.flight.record("scale_up", replica=idx, digest=digest,
                           template=True,
                           warmup_builds=info.get("warmup_builds"))
        self._publish_replica_gauges()
        return dict(rep.info, replica=idx, template_admit=True)

    # -- elastic fleet: runtime replica mutation -------------------

    def add_replica(self, timeout_s: Optional[float] = None) -> dict:
        """Spawn ONE cold replica and admit it to the rotation — but
        only after the full warm-before-admit handshake: the child
        builds + warms every bucket (no native build: the kernels'
        libraries are already built on this machine) and answers its
        `params_digest`, which must equal the fleet's. A mismatch (or a
        startup failure) kills the newcomer and raises typed
        `FleetScaleError` BEFORE it could take a single request: the
        fleet never splits and never builds in steady state on
        scale-up. Returns the admitted replica's ready info (idx, pid,
        healthz port, warmup builds and `builds_at_ready`)."""
        assert self._started, "start() the router before scaling"
        self._claim_scale("add_replica")
        try:
            # fast path: a stocked pre-warmed template turns
            # admit into digest-handshake + unpause. A miss (stale
            # digest, died in reserve) falls through to the cold spawn
            # below; either way the slot restocks in the background.
            if self._template_enabled:
                tpl = self._take_template()
                admitted = (None if tpl is None
                            else self._admit_template(tpl))
                self._kick_restock()
                if admitted is not None:
                    return admitted
                if tpl is None:
                    self.metrics.counter("serve_template_misses").inc()
                    self.flight.record("template_miss",
                                       reason="not_stocked")
            import multiprocessing
            ctx = multiprocessing.get_context("spawn")
            with self._lock:
                idx = len(self._replicas)
            try:
                rep = self._launch(idx, ctx)
            except Exception as e:  # noqa: BLE001 — typed contract
                raise FleetScaleError(
                    f"replica {idx} could not be launched for "
                    f"scale-up ({type(e).__name__}: {e})") from e
            deadline = time.monotonic() + (self.start_timeout_s
                                           if timeout_s is None
                                           else float(timeout_s))
            try:
                rep.info = self._wait_ready(rep, deadline)
            except BaseException as e:
                self._reap(rep, stop_first=True)
                raise FleetScaleError(
                    f"replica {idx} failed to start for scale-up: "
                    f"{e}") from e
            digest = rep.info.get("params_digest")
            if self.params_digest is not None \
                    and digest != self.params_digest:
                self._reap(rep, stop_first=True)
                self.metrics.counter("serve_router_digest_skew").inc()
                raise FleetScaleError(
                    f"scale-up replica {idx} built model {digest!r} but "
                    f"the fleet serves {self.params_digest!r} — killed "
                    f"before it could answer a request (re-point the "
                    f"config's checkpoint or re-swap the fleet first)")
            # ADMIT: only now does the replica become routable
            if self.params_digest is None:
                # the fleet digest was UNKNOWN (an all-skipped
                # conditional rollback): adopt the newcomer's — it just
                # passed the same build the rest of the fleet did
                self.params_digest = digest
            with self._lock:
                self._replicas.append(rep)
                self.num_replicas = len(self._replicas)
                self._state[rep.idx] = "live"
                self._fails[rep.idx] = 0
            rep.reader = threading.Thread(
                target=self._reader, args=(rep,),
                name=f"router-reader-{rep.idx}", daemon=True)
            rep.reader.start()
            self.metrics.counter("serve_router_scale_ups").inc()
            self.flight.record("scale_up", replica=rep.idx,
                               digest=digest,
                               warmup_builds=rep.info.get(
                                   "warmup_builds"))
            self._publish_replica_gauges()
            return dict(rep.info, replica=rep.idx)
        finally:
            with self._lock:
                self._scaling = False

    def drain_replica(self, idx: Optional[int] = None,
                      timeout_s: float = 30.0) -> dict:
        """Gracefully remove one replica from the fleet. The victim
        (given, or auto-picked: fewest session pins, then fewest
        in-flight, then the newest) leaves the dispatch rotation
        IMMEDIATELY (state 'draining': `_pick` skips it and pinned SI
        submits answer typed SessionExpired at the door), its in-flight
        work gets up to `timeout_s` to finish on it, then it exits
        through the SAME leave-rotation path a crash uses — stragglers
        re-dispatch / typed-fail identically, pinned sessions orphan
        with the same accounting — and the process is reaped. Refused
        typed when it would empty the fleet."""
        assert self._started, "start() the router before scaling"
        self._claim_scale("drain_replica")
        try:
            with self._lock:
                live = [rep for rep in self._replicas
                        if self._state.get(rep.idx) == "live"]
                if idx is not None:
                    victim = next((rep for rep in self._replicas
                                   if rep.idx == idx), None)
                    if victim is None or \
                            self._state.get(idx) != "live":
                        raise FleetScaleError(
                            f"replica {idx} is not live "
                            f"({self._state.get(idx, 'unknown')!r}) — "
                            f"nothing to drain")
                else:
                    pins: Dict[int, int] = {}
                    for _sid, i in self._sessions.items():
                        pins[i] = pins.get(i, 0) + 1
                    depth: Dict[int, int] = {}
                    for rep in live:
                        with rep.lock:   # frontdoor -> replica nesting
                            depth[rep.idx] = len(rep.inflight)
                    victim = min(
                        live, default=None,
                        key=lambda rep: (pins.get(rep.idx, 0),
                                         depth[rep.idx], -rep.idx))
                if victim is None or len(live) <= 1:
                    raise FleetScaleError(
                        f"refusing to drain replica "
                        f"{getattr(victim, 'idx', idx)}: it is the last "
                        f"live replica ({len(live)} live) — the fleet "
                        f"must keep serving")
                # out of the rotation NOW: no new dispatch picks it,
                # pinned submits answer typed at the door
                self._state[victim.idx] = "draining"
            self._publish_replica_gauges()
            # bounded grace for in-flight work to resolve ON the victim
            deadline = time.monotonic() + timeout_s
            inflight_left = 0
            while time.monotonic() < deadline:
                with victim.lock:
                    inflight_left = len(victim.inflight)
                if inflight_left == 0:
                    break
                time.sleep(0.01)
            # graceful stop: the child drains its service and answers
            # "bye"; the reader's EOF handling routes into
            # _leave_rotation(reason="drain") — stragglers (a wedged
            # victim) re-dispatch there exactly like a death's orphans.
            # 'stopping' marks that the EOF is now EXPECTED: a crash
            # BEFORE this point (state still 'draining') classifies as
            # a death, never a routine scale-down.
            with self._lock:
                if self._state.get(victim.idx) == "draining":
                    self._state[victim.idx] = "stopping"
            with victim.lock:
                try:
                    victim.conn.send(protocol.stop_msg())
                except (OSError, ValueError, BrokenPipeError):
                    pass
            if victim.reader is not None:
                victim.reader.join(timeout=timeout_s)
            self._leave_rotation(victim, reason="drain")  # idempotent
            self._reap(victim, timeout_s=timeout_s)
            self.metrics.counter("serve_router_scale_downs").inc()
            self._publish_replica_gauges()
            return {"replica": victim.idx,
                    "inflight_at_stop": inflight_left}
        finally:
            with self._lock:
                self._scaling = False

    def _claim_scale(self, op: str) -> None:
        with self._lock:
            if self._scaling:
                raise FleetScaleError(
                    f"{op}: a fleet scale op is already in flight — "
                    f"one at a time")
            if self._swapping:
                raise FleetScaleError(
                    f"{op}: a fleet swap is in flight — a replica "
                    f"admitted or drained mid-commit could split the "
                    f"fleet; retry after the swap settles")
            self._scaling = True

    def _reap(self, rep: _Replica, timeout_s: float = 10.0,
              stop_first: bool = False) -> None:
        """Retire one replica's process and close its pipe. The
        post-drain path already told the child to stop; the
        refused-newcomer paths pass `stop_first` so the (healthy,
        still-serving) child gets a graceful exit to react to instead
        of burning the whole join timeout. Terminate is always followed
        by a join — a SIGTERMed child whose status is never collected
        is a zombie until router shutdown."""
        if stop_first:
            try:
                rep.conn.send(protocol.stop_msg())
            except (OSError, ValueError, BrokenPipeError):
                pass
        if rep.proc is not None:
            rep.proc.join(timeout=timeout_s)
            if rep.proc.is_alive():
                rep.proc.terminate()
                rep.proc.join(timeout=5.0)
        try:
            rep.conn.close()
        except OSError:
            pass
        rep.close_rings()

    # -- fleet-coordinated hot swap --------------------------------

    def _control(self, rep: _Replica, op: str, payload=None) -> Future:
        """Ship one swap-phase op to a SPECIFIC replica; the returned
        future resolves with the replica's outcome dict, or typed
        ServiceUnavailable if it dies first (never rerouted)."""
        pending = _Pending(op, payload, "control", None, 0)
        with self._lock:
            rid = self._next_rid_locked()
        sent = False
        with rep.lock:
            rep.inflight[rid] = pending
            try:
                rep.conn.send(protocol.control_msg(op, rid, payload))
                sent = True
            except (OSError, ValueError, BrokenPipeError):
                del rep.inflight[rid]
        if not sent:
            self._on_disconnect(rep)
            pending.future.set_exception(ServiceUnavailable(
                f"replica {rep.idx} pipe is gone — cannot drive {op}"))
        return pending.future

    def _live_replicas(self) -> List[_Replica]:
        with self._lock:
            return [rep for rep in self._replicas
                    if self._state.get(rep.idx) == "live"]

    def _broadcast(self, reps, op: str, payload, timeout_s: float,
                   round_trip_ms: Optional[Dict[int, float]] = None):
        """op to every rep; returns ({idx: result}, {idx: exception}).
        `round_trip_ms`, when given, receives each replica's ms from the
        send to its answer."""
        t0 = time.monotonic()
        futs = [(rep, self._control(rep, op, payload)) for rep in reps]
        if round_trip_ms is not None:
            for rep, fut in futs:
                fut.add_done_callback(
                    lambda _f, i=rep.idx: round_trip_ms.__setitem__(
                        i, (time.monotonic() - t0) * 1e3))
        deadline = time.monotonic() + timeout_s
        results: Dict[int, Any] = {}
        errors: Dict[int, BaseException] = {}
        for rep, fut in futs:
            remaining = max(0.0, deadline - time.monotonic())
            try:
                exc = fut.exception(timeout=remaining)
            except TimeoutError:
                errors[rep.idx] = TimeoutError(
                    f"replica {rep.idx} did not answer {op} within "
                    f"{timeout_s}s")
                continue
            if exc is None:
                results[rep.idx] = fut.result(timeout=0)
            else:
                errors[rep.idx] = exc
        return results, errors

    def swap_model(self, ckpt_dir: str, prepare_timeout_s: float = 600.0,
                   commit_timeout_s: float = 60.0,
                   canary: bool = True) -> dict:
        """Two-phase fleet hot swap. Prepare on every live replica
        (each loads + manifest-verifies + warms in the background of
        its own traffic and reports the digest it built); commit only
        on a UNANIMOUS digest, under the brief dispatch gate. Any
        prepare failure aborts the whole fleet back to the old model;
        a commit failure rolls the committed replicas back — the fleet
        converges on ONE model either way, and this raises typed
        FleetSwapError naming each replica's outcome. Only LIVE
        replicas participate: one that sits out a swap evicted is
        refused readmission while its digest disagrees with the
        fleet's (`serve_router_digest_skew`) — re-swap or restart it.
        `canary=False` is the service's operator override, sent to every
        replica's prepare: no prepare-time golden canary."""
        assert self._started, "start() the router before swapping"
        with self._lock:
            if self._swapping:
                raise FleetSwapError("a fleet swap is already in flight "
                                     "— one at a time")
            if self._scaling:
                raise FleetSwapError(
                    "a fleet scale op (add/drain replica) is in flight "
                    "— a swap racing it could commit past a replica "
                    "entering or leaving the rotation; retry shortly")
            self._swapping = True
        try:
            reps = self._live_replicas()
            if not reps:
                raise ServiceUnavailable("no live replica to swap")
            prepared, errors = self._broadcast(
                reps, "swap_prepare",
                protocol.prepare_payload(ckpt_dir, canary),
                prepare_timeout_s)
            digests = {info["digest"] for info in prepared.values()}
            if errors or len(digests) != 1:
                # abort EVERY replica, not just the ones that answered:
                # a replica whose prepare merely TIMED OUT may still
                # stage later — the abort cancels the in-flight prepare
                # (SwapCoordinator refuses the late stage) so it cannot
                # park a bundle that would wedge every future swap.
                # Abort is a safe no-op where nothing is staged.
                self._broadcast(reps, "swap_abort", None,
                                commit_timeout_s)
                self.metrics.counter("serve_router_swap_aborts").inc()
                outcome = {i: f"prepared digest "
                              f"{prepared[i]['digest']}"
                           for i in prepared}
                outcome.update({i: e for i, e in errors.items()})
                raise FleetSwapError(
                    f"fleet prepare did not converge (digests "
                    f"{sorted(digests)!r}, {len(errors)} failure(s)) — "
                    f"aborted; every replica still serves the old "
                    f"model", per_replica=outcome)
            digest = digests.pop()
            # the never-two-models window: dispatch parks while every
            # replica executes its O(1) commit of the SAME digest
            self._swap_gate.clear()
            commit_ms: Dict[int, float] = {}
            try:
                committed, commit_errors = self._broadcast(
                    reps, "swap_commit", digest, commit_timeout_s,
                    round_trip_ms=commit_ms)
            finally:
                self._swap_gate.set()
            if not commit_errors:
                # every replica committed: their session stores were
                # invalidated by commit_swap, so the pins are all stale
                self._drop_all_pins("swap")
            if commit_errors:
                # converge DOWN. A commit that merely TIMED OUT may
                # still land later (the pipe is FIFO), so recovery for
                # the errored replicas is abort (clears a still-staged
                # bundle — the late commit then finds nothing) followed
                # by a CONDITIONAL rollback sent to EVERYONE: it only
                # fires where the serving digest IS the new one (a
                # late commit that did land gets rolled back; a replica
                # that never committed refuses typed). Either way each
                # replica ends on the OLD model.
                abort_reps = [r for r in reps if r.idx in commit_errors]
                self._broadcast(abort_reps, "swap_abort", None,
                                commit_timeout_s)
                self._broadcast(reps, "rollback", digest,
                                commit_timeout_s)
                self.metrics.counter("serve_router_swap_aborts").inc()
                # committed-then-rolled-back replicas cleared their
                # stores; conservatively drop EVERY pin (re-open is the
                # one client recovery anyway) rather than track which
                # replica kept its sessions through the partial commit
                self._drop_all_pins("swap")
                outcome = {i: "committed, rolled back" for i in committed}
                outcome.update({i: e for i, e in commit_errors.items()})
                raise FleetSwapError(
                    f"fleet commit failed on {len(commit_errors)} "
                    f"replica(s) — committed replicas rolled back; the "
                    f"fleet serves the OLD model", per_replica=outcome)
            self.params_digest = digest
            self.metrics.counter("serve_router_swaps").inc()
            return {"digest": digest,
                    "replicas": sorted(committed),
                    "prepare": prepared,
                    "commit": committed,
                    "commit_ms": commit_ms}
        finally:
            with self._lock:
                self._swapping = False
            # a template warmed pre-swap is stale now — refresh it in
            # the background rather than paying a miss at scale-up
            self._revalidate_template()

    def rollback(self, timeout_s: float = 60.0,
                 expect_digest: Optional[str] = None) -> dict:
        """Fleet-wide instant rollback (every replica re-instates its
        warm previous bundle) under the same dispatch gate. Partial
        failure raises FleetSwapError — the operator must know the
        fleet split rather than discover it as bit-identity flakes.

        `expect_digest` makes it CONDITIONAL per replica (the
        fleet-health driver's mode): each replica rolls back only if
        its serving digest IS the sick one; a replica already off it —
        typically because its OWN RollbackWatchdog fired first — refuses
        typed and is reported as skipped rather than failed, so the
        fleet driver converges with (never fights) a per-replica
        watchdog."""
        assert self._started, "start() the router before rollback"
        # a rollback is a fleet digest transition like a swap: claim
        # the same exclusivity so a scale op cannot admit/drain a
        # replica across the flip (the newcomer would be validated
        # against the pre-rollback digest)
        with self._lock:
            if self._swapping:
                raise FleetSwapError("a fleet swap/rollback is already "
                                     "in flight — one at a time")
            if self._scaling:
                raise FleetSwapError(
                    "a fleet scale op (add/drain replica) is in flight "
                    "— a rollback racing it could flip the digest "
                    "under an admit; retry shortly")
            self._swapping = True
        try:
            reps = self._live_replicas()
            if not reps:
                raise ServiceUnavailable("no live replica to roll back")
            self._swap_gate.clear()
            try:
                results, errors = self._broadcast(
                    reps, "rollback", expect_digest, timeout_s)
            finally:
                self._swap_gate.set()
            # every replica that rolled back invalidated its session
            # store
            self._drop_all_pins("rollback")
            skipped = {}
            if expect_digest is not None:
                # ONLY the conditional refusal counts as converged:
                # "this replica is not serving the sick digest" —
                # already rolled back (its own watchdog won the race)
                # or it never committed. Any OTHER SwapError (e.g.
                # "nothing to roll back to" from a replica that IS
                # serving the sick model with no prev bundle) is a
                # real failure — treating it as skipped would report
                # success over a split fleet.
                skipped = {i: e for i, e in errors.items()
                           if isinstance(e, SwapError)
                           and "conditional rollback refused" in str(e)}
                for i in skipped:
                    del errors[i]
            digests = {info["digest"] for info in results.values()}
            if errors or len(digests) > 1 \
                    or (not results and not skipped):
                self.metrics.counter("serve_router_swap_aborts").inc()
                outcome = {i: f"rolled back to {results[i]['digest']}"
                           for i in results}
                outcome.update({i: f"skipped: {e}"
                                for i, e in skipped.items()})
                outcome.update({i: e for i, e in errors.items()})
                raise FleetSwapError(
                    f"fleet rollback did not converge (digests "
                    f"{sorted(digests)!r}, {len(errors)} failure(s), "
                    f"{len(skipped)} skipped)", per_replica=outcome)
            if digests:
                self.params_digest = digests.pop()
            elif skipped:
                # EVERY replica had already rolled itself back: the
                # fleet is off the sick digest but nobody told this
                # router which digest it converged on — learn it from
                # /healthz instead of keeping the sick name (a stale
                # params_digest would refuse every healthy scale-up
                # newcomer). When the polls cannot resolve it (timeout,
                # split answers), record UNKNOWN rather than the sick
                # digest — the health poller re-learns it from the next
                # successful poll, and an unknown digest admits rather
                # than wedging every future scale-up on a stale value.
                polled = {d for ok, d in (self._healthz_ok(rep)
                                          for rep in reps) if ok and d}
                self.params_digest = (polled.pop() if len(polled) == 1
                                      else None)
            self.metrics.counter("serve_router_rollbacks").inc()
            return {"digest": self.params_digest,
                    "replicas": sorted(results),
                    "skipped": sorted(skipped)}
        finally:
            with self._lock:
                self._swapping = False
            # a template warmed pre-swap is stale now — refresh it in
            # the background rather than paying a miss at scale-up
            self._revalidate_template()

    # -- health -------------------------------------------------------------

    def _healthz_ok(self, rep: _Replica):
        """One /healthz poll -> (ok, serving_model_digest). Replicas
        without a port (test fakes) count as healthy while their
        transport lives, with no digest claim."""
        port = (rep.info or {}).get("healthz_port")
        if port is None:
            return (rep.proc is None or rep.proc.is_alive()), None
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz",
                    timeout=self.health_timeout_s) as resp:
                if resp.status != 200:
                    return False, None
                body = json.loads(resp.read().decode("utf-8"))
                return True, (body.get("model") or {}).get("digest")
        except Exception:   # noqa: BLE001 — any poll failure is a failure
            return False, None

    def _poll_loop(self) -> None:
        """Eviction/readmission: `evict_after` consecutive failed polls
        stop NEW traffic to a replica (in-flight work, if it is merely
        slow, still completes); one healthy poll readmits it. 'dead'
        (transport gone) is terminal — there is nobody to talk to."""
        while not self._stop.wait(self.poll_every_s):
            for rep in self._all_replicas():
                with self._lock:
                    state = self._state.get(rep.idx)
                if state in ("dead", "drained", "draining", "stopping"):
                    # terminal (nobody to talk to) or already leaving
                    # the rotation on purpose — polling it could only
                    # readmit a replica mid-drain
                    continue
                # no locks across the poll
                ok, digest = self._healthz_ok(rep)
                with self._lock:
                    if self._state.get(rep.idx) in ("dead", "drained",
                                                    "draining",
                                                    "stopping"):
                        continue
                    if ok:
                        self._fails[rep.idx] = 0
                        if (self.params_digest is None
                                and digest is not None
                                and self._state[rep.idx] == "live"):
                            # an all-skipped conditional rollback left
                            # the fleet digest UNKNOWN — re-learn it
                            # from the first live replica that answers
                            self.params_digest = digest
                        if self._state[rep.idx] == "evicted":
                            if (digest is not None
                                    and self.params_digest is not None
                                    and digest != self.params_digest):
                                # healthy but serving the WRONG model —
                                # it missed a fleet swap while evicted.
                                # Readmitting it would split the fleet;
                                # keep it out and surface the skew for
                                # the operator (re-swap or restart it).
                                self.metrics.counter(
                                    "serve_router_digest_skew").inc()
                                continue
                            self._state[rep.idx] = "live"
                            self.metrics.counter(
                                "serve_router_readmissions").inc()
                    else:
                        self._fails[rep.idx] += 1
                        if (self._fails[rep.idx] >= self.evict_after
                                and self._state[rep.idx] == "live"):
                            self._state[rep.idx] = "evicted"
                            self.metrics.counter(
                                "serve_router_evictions").inc()

    def health(self) -> dict:
        with self._lock:
            states = {str(rep.idx): self._state.get(rep.idx, "unknown")
                      for rep in self._replicas}
        live = sum(1 for s in states.values() if s == "live")
        # drained/draining/stopping replicas are leaving the fleet ON
        # PURPOSE: they are not degradation — only non-live
        # replicas that are still SUPPOSED to be serving count against
        # the status (a routine scale-down must not page anyone)
        expected = sum(1 for s in states.values()
                       if s not in ("drained", "draining", "stopping"))
        status = ("ok" if live and live == expected
                  else "degraded" if live else "unhealthy")
        return {"status": status, "live": live, "replicas": states,
                "outstanding": self.admission.outstanding(),
                "params_digest": self.params_digest}

    # -- shutdown -----------------------------------------------------------

    def drain(self, timeout_s: float = 60.0) -> None:
        """Graceful: stop polling, ask every replica to drain (their
        queued work resolves typed there and the answers flow back),
        join, then fail anything still unresolved — no hung futures."""
        self._stop.set()
        self._swap_gate.set()     # never strand a dispatcher on drain
        if self._template_enabled:
            # the reserve replica never took traffic; stop it like any
            # other child. A stock still in flight sees _stop set,
            # aborts its wait, and reaps its own spawn (rings included)
            # — JOIN it so the /dev/shm census is clean when drain
            # returns, then sweep anything stocked in between.
            self._discard_template(restock=False)
            with self._template_lock:
                stocker = self._template_thread
            if stocker is not None and stocker.is_alive():
                stocker.join(timeout=timeout_s)
            self._discard_template(restock=False)
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        if self._poller is not None:
            self._poller.join(timeout=timeout_s)
        replicas = self._all_replicas()
        for rep in replicas:
            with rep.lock:
                try:
                    rep.conn.send(protocol.stop_msg())
                except (OSError, ValueError, BrokenPipeError):
                    pass
        for rep in replicas:
            if rep.reader is not None:
                rep.reader.join(timeout=timeout_s)
        for rep in replicas:
            if rep.proc is not None:
                rep.proc.join(timeout=timeout_s)
                if rep.proc.is_alive():
                    rep.proc.terminate()
            try:
                rep.conn.close()
            except OSError:
                pass
            rep.close_rings()
            with rep.lock:
                leftovers = list(rep.inflight.values())
                rep.inflight.clear()
            for pending in leftovers:
                if not pending.future.done():
                    pending.future.set_exception(ServiceUnavailable(
                        "front door drained with this request in flight"))
        self.flight.flush(timeout=5.0)
        self.flight.close()


# -- router-level /metrics aggregation --------------------

class AggregatedMetrics:
    """ONE fleet-wide metrics view: the router's own registry merged
    with a live scrape of every replica's `/metrics?format=json`.

    Merge rules (each scrape is a fresh fan-out — no caching, matching
    a single service's scrape semantics): counters, gauges, and
    accumulators SUM across the router + replicas (queue depths, worker
    counts, stage milliseconds all add meaningfully); histograms merge
    as total count, count-weighted mean, and the fleet-wide MAX p50/p99
    (quantiles do not compose exactly from summaries, and for an
    operator's SLO view the worst replica is the honest aggregate —
    per-replica values remain one port away). The info section carries
    the router's own info, each replica's scraped info + model digest
    (the fleet-version-skew view the two-phase swap maintains), and
    which replicas failed to answer the scrape. Duck-types the
    `MetricsRegistry` surface `MetricsServer` needs (`snapshot()` /
    `render_text()`), so `FrontDoorRouter(metrics_port=...)` serves it
    over the standard endpoint.

    Staleness: a scrape that ANSWERS is not
    necessarily FRESH — a wedged replica (or an interposed cache) can
    keep serving the same frozen snapshot while its dataplane is dead.
    Registry snapshots therefore carry a per-process monotonic `seq`
    (incremented by the snapshot itself) and a `captured_at` wall
    timestamp; this view remembers the last seq it saw per replica and
    treats a non-advancing seq, or a capture older than
    `stale_after_s`, as STALE — flagged in `info.replicas_stale` and
    excluded from the merge, never silently averaged in."""

    #: capture-timestamp slack before a scrape counts as stale (same
    #: host, so clock skew is not a concern at this scale)
    stale_after_s = 5.0

    def __init__(self, router: "FrontDoorRouter"):
        self._router = router
        # last seen snapshot seq per replica idx; the scrape loop may
        # run concurrently from ThreadingHTTPServer handler threads
        self._seq_lock = threading.Lock()
        self._last_seq: Dict[int, int] = {}   # guarded-by: self._seq_lock

    def _is_stale(self, idx: int, snap: dict, now: float) -> bool:
        """Freshness verdict for one replica scrape. A missing seq
        (a test fake) is not judged — only
        POSITIVE evidence of staleness flags a replica. The seq test is
        EQUALITY, not <=: a live registry mints a fresh seq per
        snapshot, so two concurrent scrapes legitimately observe
        adjacent seqs in either order (a <= test would falsely flag the
        loser of that race), while a frozen/cached response replays the
        IDENTICAL seq — the signature being hunted. A seq that went
        BACKWARDS (replica restart) is fresh numbers, not stale ones."""
        seq = snap.get("seq")
        captured = snap.get("captured_at")
        stale = False
        if seq is not None:
            with self._seq_lock:
                prev = self._last_seq.get(idx)
                if prev is not None and seq == prev:
                    stale = True
                else:
                    self._last_seq[idx] = seq
        if captured is not None and now - captured > self.stale_after_s:
            stale = True
        return stale

    def _scrape(self, rep: _Replica) -> Optional[dict]:
        port = (rep.info or {}).get("healthz_port")
        if port is None:
            return None
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics?format=json",
                timeout=self._router.health_timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def snapshot(self) -> dict:
        own = self._router.metrics.snapshot()
        counters = dict(own["counters"])
        gauges = dict(own["gauges"])
        accumulators = dict(own["accumulators"])
        # histogram partials ride the shared two-tier merge helpers
        # (serve/metrics.py) — the federation applies the
        # identical rules to MEMBER roll-ups, one implementation
        hist: Dict[str, list] = metrics_lib.hist_partials(
            own["histograms"])
        per_replica_info: Dict[str, dict] = {}
        digests: Dict[str, Optional[str]] = {}
        unreachable = []
        stale = []
        # fan the scrapes out: unreachable replicas each burn up to
        # health_timeout_s, and paying that N times IN SERIES would
        # blow the operator's scrape interval — concurrent GETs bound
        # the endpoint at ~one timeout total
        from concurrent.futures import ThreadPoolExecutor

        def _safe_scrape(rep):
            try:
                return self._scrape(rep)
            except Exception:   # noqa: BLE001 — a dead scrape is data
                return None
        replicas = self._router._all_replicas()
        with self._router._lock:
            replica_states = {str(rep.idx):
                              self._router._state.get(rep.idx, "unknown")
                              for rep in replicas}
        # per-replica occupancy: the scaler's
        # primary input, published as a structural fact instead of
        # being hand-derived from counters. The router-side outstanding
        # depth (its in-flight map) is available even for a replica
        # whose scrape fails; the replica-side queue depth and batch
        # occupancy join it where the scrape answers.
        occupancy: Dict[str, dict] = {}
        for rep in replicas:
            with rep.lock:
                outstanding = len(rep.inflight)
            occupancy[str(rep.idx)] = {
                "state": replica_states[str(rep.idx)],
                "outstanding": outstanding,
                "queue_depth": None,
                "batch_occupancy_mean": None,
            }
        replica_errors: Dict[str, dict] = {}
        # scrape only replicas that can still answer: a long-lived
        # autoscaled fleet accretes terminally dead/drained slots in
        # the append-only list, and paying a doomed HTTP timeout per
        # retired replica on EVERY snapshot (while permanently
        # polluting replicas_unreachable) would mask a genuinely
        # unreachable LIVE replica. Their identity stays in
        # replica_digests/replica_states/replica_occupancy.
        targets = [rep for rep in replicas
                   if replica_states[str(rep.idx)]
                   not in ("dead", "drained")]
        for rep in replicas:
            if rep not in targets:
                digests[str(rep.idx)] = (rep.info or {}).get(
                    "params_digest")
        with ThreadPoolExecutor(
                max_workers=max(1, len(targets) or 1)) as pool:
            snaps = list(pool.map(_safe_scrape, targets))
        now = time.time()
        for rep, snap in zip(targets, snaps):
            if snap is None:
                unreachable.append(rep.idx)
                digests[str(rep.idx)] = (rep.info or {}).get(
                    "params_digest")
                continue
            if self._is_stale(rep.idx, snap, now):
                # frozen numbers are worse than missing ones: flag the
                # replica and keep its stale values OUT of the merge
                stale.append(rep.idx)
                digests[str(rep.idx)] = (rep.info or {}).get(
                    "params_digest")
                continue
            metrics_lib.merge_numeric_sections(
                counters, gauges, accumulators, hist, snap)
            info = snap.get("info", {})
            per_replica_info[str(rep.idx)] = info
            model = info.get("serve_model_digest") or {}
            digests[str(rep.idx)] = (model.get("digest")
                                     or (rep.info or {}).get(
                                         "params_digest"))
            occ = occupancy[str(rep.idx)]
            occ["queue_depth"] = snap.get("gauges", {}).get(
                "serve_queue_depth")
            bo = snap.get("histograms", {}).get("serve_batch_occupancy")
            if bo:
                occ["batch_occupancy_mean"] = bo.get("mean")
            # per-replica typed-error evidence: the fleet
            # health driver needs the SKEW across replicas — a summed
            # counter cannot say whether one replica or the whole
            # model is sick
            replica_errors[str(rep.idx)] = {
                "typed_errors": snap.get("counters", {}).get(
                    "serve_typed_errors", 0),
                "resolved": snap.get("counters", {}).get(
                    "serve_resolved", 0),
            }
        histograms = metrics_lib.fold_hist_partials(hist)
        # fleet model-health roll-up: the per-bucket gap/bpp
        # histograms merge through the generic rules above; the canary
        # verdicts are per-replica structural facts, so the aggregate
        # names WHICH replicas' canaries are failing instead of letting
        # a summed gauge average a sick replica away
        canary: Dict[str, Any] = {}
        canary_failing = []
        for idx, info in per_replica_info.items():
            c = info.get("serve_canary")
            if isinstance(c, dict):
                canary[idx] = {"status": c.get("status"),
                               "digest": c.get("digest")}
                if c.get("status") == "failed":
                    canary_failing.append(int(idx))
        return {
            "info": {
                "router": own["info"],
                "replica_digests": digests,
                "replica_states": replica_states,
                "replica_occupancy": occupancy,
                "per_replica": per_replica_info,
                "replicas_scraped": len(per_replica_info),
                "replicas_unreachable": unreachable,
                "replicas_stale": stale,
                "quality": {
                    "canary": canary,
                    "replicas_canary_failing": sorted(canary_failing),
                    "fleet_canary_ok": (not canary_failing) if canary
                    else None,
                    "replica_errors": replica_errors,
                },
            },
            "counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "accumulators": dict(sorted(accumulators.items())),
            "histograms": histograms,
            # freshness evidence one tier up: the aggregate carries its
            # own router registry's seq and capture timestamp (a
            # frozen/cached response replays the identical pair)
            "seq": own.get("seq"),
            "captured_at": own.get("captured_at"),
        }

    def render_text(self) -> str:
        return metrics_lib.render_snapshot_text(self.snapshot())


# -- router-level /trace aggregation -------------------------------

class AggregatedTraces:
    """ONE fleet-wide trace view: the router's own span ring merged
    with a live `/trace` scrape of every replica, stitched onto one
    wall-clock timeline (spans carry wall anchors precisely because
    monotonic bases do not compare across processes).

    A front-door request's trace id indexes the router.dispatch span
    (minted router-side, the context crossed the pipe) AND the
    replica-internal queue/device/entropy/SI spans — the scrape
    forwards the `?id=` filter so per-trace lookups stay cheap at the
    replicas. Mirrors AggregatedMetrics' scrape semantics: fresh
    fan-out per call, unreachable replicas reported, concurrent GETs so
    N dead replicas cost ~one timeout total."""

    def __init__(self, router: "FrontDoorRouter"):
        self._router = router

    def _scrape(self, rep: _Replica,
                trace_id: Optional[str]) -> Optional[dict]:
        port = (rep.info or {}).get("healthz_port")
        if port is None:
            return None
        url = f"http://127.0.0.1:{port}/trace"
        if trace_id is not None:
            url += f"?id={trace_id}"
        with urllib.request.urlopen(
                url, timeout=self._router.health_timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def snapshot(self, trace_id: Optional[str] = None) -> dict:
        own = self._router.tracer.snapshot(trace_id=trace_id)
        from concurrent.futures import ThreadPoolExecutor

        def _safe(rep):
            try:
                return self._scrape(rep, trace_id)
            except Exception:   # noqa: BLE001 — a dead scrape is data
                return None
        all_replicas = self._router._all_replicas()
        with self._router._lock:
            # retired (dead/drained) replicas cannot answer: scraping
            # them pays a doomed timeout per snapshot forever
            replicas = [rep for rep in all_replicas
                        if self._router._state.get(rep.idx)
                        not in ("dead", "drained")]
        scraped = 0
        unreachable = []
        parts = [own]
        if replicas:
            with ThreadPoolExecutor(max_workers=len(replicas)) as pool:
                snaps = list(pool.map(_safe, replicas))
            for rep, snap in zip(replicas, snaps):
                if snap is None:
                    unreachable.append(rep.idx)
                    continue
                scraped += 1
                parts.append(snap)
        return {
            "spans": trace_lib.merge_trace_snapshots(parts),
            "router_spans": len(own["spans"]),
            "replicas_scraped": scraped,
            "replicas_unreachable": unreachable,
            "flight": self._router.flight.meta(),
        }

    def http_snapshot(self, params: Mapping[str, str]) -> object:
        """/trace provider for the router's MetricsServer: same query
        surface as a single service (`?id=`, `?format=chrome`), fleet-
        merged."""
        snap = self.snapshot(trace_id=params.get("id"))
        if params.get("format") == "chrome":
            return trace_lib.chrome_trace(snap["spans"])
        return snap
