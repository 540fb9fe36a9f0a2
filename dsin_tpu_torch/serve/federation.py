"""The router of routers (a copy of the JAX package's
`serve/federation.py`, in PyTorch's idiom): staged rollout waves,
wave-gated canary promotion and partition-tolerant rollback over member
`FrontDoorRouter` fleets.

* **FederatedRouter** treats each host's `FrontDoorRouter` as one
  `Member`. Health comes from the member's health answer and its
  `AggregatedMetrics` roll-up with the SAME staleness veto the router
  applies to replica scrapes (a member snapshot carries its own
  `seq`/`captured_at`; a frozen or cached answer replays the identical
  pair and is flagged, never merged). Members are evicted after
  `evict_after` consecutive failed polls and readmitted on one healthy
  poll, unless their serving digest skews from the federation's
  (`federation_digest_skew`), with one exception below.

* **Sessions stay host-sticky.** Session ids are globally unique, so the
  federation pins sid -> member as the router pins sid -> replica. A
  pinned member that is not live answers typed `SessionExpired`.

* **Admission budgets split hierarchically.** The federation's door
  holds the sum of the live members' own fleet budgets (themselves
  scaled by each router's replica count) and derives it again on every
  change of membership.

* **Checkpoint distribution** rides the CRC-verified
  `replicate_checkpoint` (`train/checkpoint.py`): a member with a
  `ckpt_root` gets the checkpoint staged into its own root before its
  swap.

* **Rollout waves** replace the single fleet's unanimous swap. A
  `RolloutPlan` names waves of members; each wave (a) distributes and
  two-phase-swaps its members, (b) holds at the CANARY GATE, polling each
  member's quality roll-up until its golden-canary prober has probed the
  NEW digest through the member's serve path
  (`quality.wave_canary_verdict`: a verdict still naming the old digest is
  "not yet", never "pass"), then (c) holds a SOAK window that drives a
  `FleetHealthPolicy` over each member's health evidence. A wave failure
  rolls that wave back (and the earlier waves, when the plan says so)
  CONDITIONALLY, `rollback(expect_digest=<new>)` per member, and raises
  typed `RolloutAborted` naming every member's outcome.

* **Partition healing.** A member partitioned away mid-rollout fails its
  scrapes and refuses control ops (typed `MemberUnreachable`, counted per
  member); the abort records the digest it rolled away from. When the
  partition heals, a member serving that aborted digest would be refused
  for skew; instead the federation RECONCILES with one conditional
  rollback and only then readmits it.

* **Traces stitch across both router tiers.** The federation mints the
  `TraceContext`, records the `federation.dispatch` span and passes the
  context through the member router's `submit_*(trace=...)`, which
  records `router.dispatch` and ships it to the replica: one trace id
  indexes the federation, router and replica spans (`FederatedTraces`).

Locks: `threading.Lock` stands where the JAX package ranks its
`serve.federation` lock (the outermost). It guards only the member
table, the pin map and the rollout bookkeeping; no member call, scrape
or executor wait runs under it.

The transport seam: `Member` wraps an in-process `FrontDoorRouter` the
way an RPC client wraps a remote host. Every federation -> member call
goes through `Member.call()`, which bounds its wait and answers typed
`MemberUnreachable` (counted per member) on a timeout or a partition.
`partition()` / `heal()` flip the seam for the chaos battery
(`tools/chaos_bench.py --federation_only`); the serve bench's
`--federation_only` leg measures the tier under load.
"""

from __future__ import annotations

import threading
import time
from concurrent import futures as cf
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Mapping, Optional,
                    Sequence, Set, Tuple)

from dsin_tpu_torch.serve import metrics as metrics_lib
from dsin_tpu_torch.serve import trace as trace_lib
from dsin_tpu_torch.serve.autoscale import (FleetHealthPolicy,
                                            health_from_snapshot)
from dsin_tpu_torch.serve.batcher import (Future, ServeError,
                                          ServiceOverloaded,
                                          ServiceUnavailable)
from dsin_tpu_torch.serve.quality import wave_canary_verdict
from dsin_tpu_torch.serve.router import (AdmissionController,
                                         FleetSwapError, FrontDoorRouter)
from dsin_tpu_torch.serve.session import SessionExpired


class FederationError(RuntimeError):
    """A federation control op was refused (unknown member, a second
    rollout while one is in flight, a plan that names nobody). The
    federation keeps serving its current state — a refused control op
    is an operator error, never an outage."""


class MemberUnreachable(ServeError):
    """A federation -> member call could not complete: the member is
    partitioned away, or the bounded call timeout expired. Typed as a
    ServeError so dataplane callers shed/reroute it like any other
    serving refusal; carries `member` for the operator."""

    def __init__(self, msg: str, member: Optional[str] = None):
        super().__init__(msg)
        self.member = member


class RolloutAborted(FederationError):
    """A rollout wave failed its gate (swap refusal, canary mismatch
    through the new model's real serve path, soak-window health fire,
    or a member lost mid-wave) and the federation auto-rolled the wave
    back. Carries `digest` (the manifest being promoted), `wave` (the
    0-based failing wave), `reason`, and `per_wave` — {wave_idx:
    {member: outcome-str}} covering every member the rollout touched —
    so the operator sees exactly where the promotion stopped and what
    every member converged to."""

    def __init__(self, msg: str, *, digest: Optional[str] = None,
                 wave: Optional[int] = None, reason: str = "",
                 per_wave: Optional[Dict[int, Dict[str, str]]] = None):
        super().__init__(msg)
        self.digest = digest
        self.wave = wave
        self.reason = reason
        self.per_wave = {w: dict(m) for w, m in (per_wave or {}).items()}


class Member:
    """One host's fleet, as the federation sees it: a name, the
    `FrontDoorRouter` handle (the in-process stand-in for an RPC
    client), an optional `ckpt_root` the checkpoint distribution
    stages manifests into, and the partitionable call seam.

    `call(kind, fn, timeout_s)` is the ONLY way the federation invokes
    member machinery: it refuses immediately when the member is
    partitioned and otherwise runs `fn` on the member's own
    single-thread executor with a bounded wait — a call that outlives
    its timeout answers typed `MemberUnreachable` (the executor thread
    keeps draining, mirroring an RPC whose response is abandoned).
    Every refusal/timeout increments the per-member failure counter on
    the federation registry (no unbounded cross-host call: every failure is typed AND
    counted)."""

    def __init__(self, name: str, router: FrontDoorRouter, *,
                 ckpt_root: Optional[str] = None,
                 control_timeout_s: float = 60.0):
        if not name:
            raise FederationError("a member needs a non-empty name")
        self.name = str(name)
        self.router = router
        self.ckpt_root = ckpt_root
        self.control_timeout_s = float(control_timeout_s)
        self._partitioned = threading.Event()
        # a small pool of call lanes, like an RPC channel pool: a slow
        # control op (a swap's prepare runs minutes) must not starve
        # the concurrent health polls into spurious evictions
        self._pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix=f"fed-member-{name}")
        #: set by FederatedRouter.attach — failures count on the
        #: federation's registry so the roll-up carries them
        self.metrics: Optional[metrics_lib.MetricsRegistry] = None

    # -- the partition seam --------------------------------------------------

    def partition(self) -> None:
        """Model a network partition: every federation->member call
        (scrape, health, control op, dataplane handoff) is refused
        typed until `heal()`. The member itself keeps serving its own
        local traffic — the federation lost the HOST, the host did not
        lose its fleet."""
        self._partitioned.set()

    def heal(self) -> None:
        self._partitioned.clear()

    @property
    def partitioned(self) -> bool:
        return self._partitioned.is_set()

    # -- the bounded, typed call surface -------------------------------------

    def _count_failure(self, kind: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                f"federation_member_call_failures_{self.name}").inc()
            self.metrics.counter(
                f"federation_member_call_failures_{self.name}_{kind}"
            ).inc()

    def call(self, kind: str, fn: Callable[[], Any],
             timeout_s: Optional[float] = None) -> Any:
        """Invoke one member operation, bounded + typed (see class
        docstring). `kind` labels the failure counter and the error."""
        if self._partitioned.is_set():
            self._count_failure(kind)
            raise MemberUnreachable(
                f"member {self.name!r} is partitioned away "
                f"({kind} refused)", member=self.name)
        budget = (self.control_timeout_s if timeout_s is None
                  else float(timeout_s))
        fut = self._pool.submit(fn)
        try:
            return fut.result(timeout=budget)
        except (cf.TimeoutError, TimeoutError):
            self._count_failure(kind)
            raise MemberUnreachable(
                f"member {self.name!r} did not answer {kind} within "
                f"{budget}s", member=self.name) from None

    def close(self) -> None:
        self._pool.shutdown(wait=False)


@dataclass(frozen=True)
class RolloutPlan:
    """A staged promotion: `waves` are tuples of member names promoted
    together; every wave must pass its canary gate AND its soak window
    before the next wave starts. `soak_s=0` skips the soak (the canary
    gate still holds). `rollback_prior_waves` extends a wave failure's
    auto-rollback to the already-committed waves — blast-radius policy
    is the OPERATOR's call, so both behaviors are first-class."""

    ckpt_dir: str
    waves: Tuple[Tuple[str, ...], ...]
    #: wave canary gate: poll member quality roll-ups until every wave
    #: member's prober has verdicts covering the NEW digest
    canary_timeout_s: float = 120.0
    poll_s: float = 0.05
    #: post-commit soak window per wave (0 = skip)
    soak_s: float = 0.0
    #: member swap/rollback call budgets (prepare loads + warms a model)
    swap_timeout_s: float = 600.0
    rollback_timeout_s: float = 60.0
    rollback_prior_waves: bool = False
    #: stage the manifest into each member's ckpt_root first (members
    #: without one swap straight from `ckpt_dir` — one shared
    #: filesystem, the single-host test shape)
    distribute: bool = True

    def validate(self, known: Sequence[str]) -> None:
        if not self.waves or any(not w for w in self.waves):
            raise FederationError(
                f"a rollout plan needs non-empty waves, got "
                f"{self.waves!r}")
        seen: Set[str] = set()
        for wave in self.waves:
            for name in wave:
                if name not in known:
                    raise FederationError(
                        f"rollout names unknown member {name!r} "
                        f"(members: {sorted(known)})")
                if name in seen:
                    raise FederationError(
                        f"member {name!r} appears in two waves — a "
                        f"member promotes exactly once per rollout")
                seen.add(name)


class FederatedRouter:
    """The router-of-routers (see module docstring). Members are
    handed in started; the federation owns NO member lifecycle — it
    routes, polls, promotes, and rolls back. `drain()` stops only the
    federation's own machinery (each host drains its own fleet)."""

    def __init__(self, members: Sequence[Member], *,
                 admission_limits: Optional[Mapping[str, int]] = None,
                 poll_every_s: float = 0.25, evict_after: int = 2,
                 health_timeout_s: float = 2.0,
                 trace_sample_rate: float = 0.0,
                 trace_capacity: int = 4096,
                 flight_dir: Optional[str] = None):
        if not members:
            raise FederationError("a federation needs at least one "
                                  "member")
        names = [m.name for m in members]
        if len(set(names)) != len(names):
            raise FederationError(f"member names must be unique, got "
                                  f"{names}")
        if evict_after < 1:
            raise FederationError(
                f"evict_after must be >= 1, got {evict_after}")
        self.poll_every_s = float(poll_every_s)
        self.evict_after = int(evict_after)
        self.health_timeout_s = float(health_timeout_s)
        self.metrics = metrics_lib.MetricsRegistry()
        self._members: Dict[str, Member] = {}
        for m in members:
            m.metrics = self.metrics
            self._members[m.name] = m
        # the member class sets must agree — a heterogeneous class map
        # cannot split one budget hierarchically
        class_sets = {tuple(sorted(m.router.admission.limits))
                      for m in members}
        if len(class_sets) != 1:
            raise FederationError(
                f"members disagree on priority classes: "
                f"{sorted(class_sets)}")
        self._class_names = list(members[0].router._class_names)
        #: per-member per-class budgets, captured at attach — the
        #: hierarchical split's denominators (a member's own budget is
        #: already replica-scaled by its router)
        self._member_limits: Dict[str, Dict[str, int]] = {
            m.name: dict(m.router.admission.limits) for m in members}
        self._explicit_limits = (dict(admission_limits)
                                 if admission_limits is not None
                                 else None)
        self._lock = threading.Lock()
        self._state: Dict[str, str] = {
            m.name: "live" for m in members}  # guarded-by: self._lock
        self._fails: Dict[str, int] = {
            m.name: 0 for m in members}       # guarded-by: self._lock
        self._digests: Dict[str, Optional[str]] = {
            m.name: None for m in members}    # guarded-by: self._lock
        self._rr: Dict[str, int] = {}         # guarded-by: self._lock
        # sid -> member name: the host-sticky pin table
        self._sessions: Dict[str, str] = {}   # guarded-by: self._lock
        self._rolling = False                 # guarded-by: self._lock
        #: digests a failed/aborted rollout rolled the federation away
        #: from — the partition-healing reconcile set (never shrinks;
        #: a digest aborted once must never be readmitted silently)
        self._aborted: Set[str] = set()       # guarded-by: self._lock
        self.params_digest: Optional[str] = None
        #: the last rollout's seconds per wave: {wave: {"distribute_s",
        #: "swap_s", "canary_gate_s", "soak_s"}} (written by the one
        #: rollout in flight, read after it returns or raises)
        self.rollout_timing: Dict[int, Dict[str, float]] = {}
        self.admission = self._build_admission()
        self.tracer = trace_lib.Tracer(
            sample_rate=trace_sample_rate, capacity=trace_capacity,
            metrics=self.metrics)
        self.flight = trace_lib.FlightRecorder(
            dump_dir=flight_dir, metrics=self.metrics)
        self.aggregate = FederatedMetrics(self)
        self.traces = FederatedTraces(self)
        self._stop = threading.Event()
        self._poller: Optional[threading.Thread] = None
        self._started = False

    # -- admission (hierarchical split) --------------------------------------

    def _build_admission(self) -> AdmissionController:
        return AdmissionController(self._derive_limits(),
                                   metrics=self.metrics)

    def _derive_limits(self) -> Dict[str, int]:
        """Aggregate per-class budget = sum of LIVE members' own fleet
        budgets (floor 1: AdmissionController refuses a 0 cap — with
        no live member the door sheds on routing, not on the cap)."""
        if self._explicit_limits is not None:
            return dict(self._explicit_limits)
        with self._lock:
            live = [n for n, s in self._state.items() if s == "live"]
        totals = {c: 0 for c in self._class_names}
        for name in live:
            for c, n in self._member_limits[name].items():
                totals[c] += int(n)
        return {c: max(1, n) for c, n in totals.items()}

    def _rescale_admission(self) -> None:
        if self._explicit_limits is None:
            self.admission.set_limits(self._derive_limits())

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FederatedRouter":
        if self._started:
            return self
        # learn the federation digest from the members (unanimous or
        # UNKNOWN — the poll loop re-learns it like the router does
        # after an all-skipped rollback)
        digests = set()
        for name, member in self._members.items():
            try:
                h = member.call("health", member.router.health,
                                self.health_timeout_s)
            except MemberUnreachable:
                continue
            d = h.get("params_digest")
            with self._lock:
                self._digests[name] = d
            if d is not None:
                digests.add(d)
        if len(digests) == 1:
            self.params_digest = digests.pop()
        self._publish_members()
        self._poller = threading.Thread(target=self._poll_loop,
                                        name="federation-poller",
                                        daemon=True)
        self._started = True
        self._poller.start()
        return self

    def drain(self, timeout_s: float = 30.0) -> None:
        """Stop the federation machinery (poll loop, member call
        lanes, flight flush). Members keep serving — each host owns
        its own fleet's drain."""
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=timeout_s)
        for member in self._members.values():
            member.close()
        with self._lock:
            leftovers = len(self._sessions)
            self._sessions.clear()
        if leftovers:
            self.metrics.counter(
                "federation_sessions_dropped_drain").inc(leftovers)
        self.flight.flush(timeout=5.0)

    def __enter__(self) -> "FederatedRouter":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.drain()

    # -- health / membership -------------------------------------------------

    def members(self) -> List[str]:
        return sorted(self._members)

    def member(self, name: str) -> Member:
        m = self._members.get(name)
        if m is None:
            raise FederationError(
                f"unknown member {name!r} (members: "
                f"{sorted(self._members)})")
        return m

    def _publish_members(self) -> None:
        with self._lock:
            live = sum(1 for s in self._state.values() if s == "live")
        self.metrics.gauge("federation_members_live").set(live)
        self.metrics.gauge("federation_members").set(
            len(self._members))

    def _member_evidence(self, member: Member):
        """One bounded health poll -> (ok, serving digest). Healthy
        means the member ANSWERED and has at least one live replica —
        a host whose fleet is gone is not a routing target even if its
        front door still replies."""
        try:
            h = member.call("health", member.router.health,
                            self.health_timeout_s)
        except MemberUnreachable:
            return False, None
        except Exception:   # noqa: BLE001 — any poll failure is a failure
            return False, None
        return bool(h.get("live", 0) >= 1), h.get("params_digest")

    def _poll_loop(self) -> None:
        """Member eviction/readmission on scrape evidence, one tier
        above the router's replica poll loop — with the partition-
        healing reconcile (module docstring) grafted onto the digest-
        skew refusal."""
        while not self._stop.wait(self.poll_every_s):
            for name, member in list(self._members.items()):
                ok, digest = self._member_evidence(member)
                reconcile_digest: Optional[str] = None
                with self._lock:
                    state = self._state[name]
                    if ok:
                        self._fails[name] = 0
                        self._digests[name] = digest
                        if (self.params_digest is None
                                and digest is not None
                                and state == "live"):
                            # re-learn an UNKNOWN federation digest
                            # from the first live member that answers
                            self.params_digest = digest
                        if state == "evicted":
                            if (digest is not None
                                    and self.params_digest is not None
                                    and digest != self.params_digest):
                                if digest in self._aborted:
                                    # healed partition serving a digest
                                    # a failed rollout rolled away from:
                                    # reconcile OUTSIDE the lock, then
                                    # let the next poll readmit
                                    reconcile_digest = digest
                                else:
                                    self.metrics.counter(
                                        "federation_digest_skew").inc()
                            else:
                                self._state[name] = "live"
                                self.metrics.counter(
                                    "federation_member_readmissions"
                                ).inc()
                    else:
                        self._fails[name] += 1
                        if (self._fails[name] >= self.evict_after
                                and state == "live"):
                            self._state[name] = "evicted"
                            self.metrics.counter(
                                "federation_member_evictions").inc()
                            self.flight.record("member_evicted",
                                               member=name)
                if reconcile_digest is not None:
                    self._reconcile(member, reconcile_digest)
            self._publish_members()
            # membership drives the hierarchical budget: an evicted
            # member's share must stop being admitted at the door
            self._rescale_admission()

    def _reconcile(self, member: Member, sick: str) -> None:
        """Converge a healed member off an aborted digest: ONE
        conditional rollback — a member already off it (its own driver
        won the race, or the swap never landed) refuses typed and
        counts converged. Success or converged-refusal both leave the
        member one healthy poll away from readmission; any other
        failure leaves it evicted with the skew counter telling the
        operator why."""
        try:
            member.call(
                "reconcile_rollback",
                lambda: member.router.rollback(expect_digest=sick))
            self.metrics.counter("federation_reconciles").inc()
            self.flight.record("reconcile", member=member.name,
                               rolled_from=sick)
        except MemberUnreachable:
            return      # partition re-opened: next poll re-evaluates
        except FleetSwapError as e:
            self.metrics.counter(
                "federation_reconcile_failures").inc()
            self.flight.note_error(e)

    def health(self) -> dict:
        with self._lock:
            states = dict(self._state)
            digests = dict(self._digests)
        live = sum(1 for s in states.values() if s == "live")
        status = ("ok" if live and live == len(states)
                  else "degraded" if live else "unhealthy")
        return {"status": status, "live": live, "members": states,
                "member_digests": digests,
                "outstanding": self.admission.outstanding(),
                "params_digest": self.params_digest}

    # -- dataplane -----------------------------------------------------------

    def _pick(self, cls: str) -> Optional[Member]:
        with self._lock:
            live = [self._members[n] for n in sorted(self._members)
                    if self._state[n] == "live"]
            if not live:
                return None
            i = self._rr.get(cls, 0)
            self._rr[cls] = i + 1
            return live[i % len(live)]

    def _attach_span(self, fut: Future, ctx, op: str, cls: str,
                     member_name: str, t0: float) -> None:
        def _resolved(f):
            exc = f.exception(timeout=0)
            self.tracer.span_for(ctx, trace_lib.SPAN_FEDERATION, t0,
                                 time.monotonic(), op=op, cls=cls,
                                 member=member_name)
            if exc is not None and isinstance(exc, (ServeError,
                                                    ValueError)):
                self.tracer.error(ctx, exc)
                self.flight.note_error(
                    exc, trace_id=ctx.trace_id if ctx else None)

        fut.add_done_callback(_resolved)

    def _submit(self, op: str, payload, priority: Optional[str],
                deadline_ms: Optional[float]) -> Future:
        assert self._started, "start() the federation before submitting"
        cls = priority or self._class_names[0]
        try:
            self.admission.admit(cls)   # the federation's own door
        except ServiceOverloaded:
            self.flight.record("shed", reason="admission", cls=cls)
            raise
        ctx = self.tracer.mint(origin="federation")
        t0 = time.monotonic()
        last: Optional[BaseException] = None
        for _ in range(len(self._members)):
            member = self._pick(cls)
            if member is None:
                break
            try:
                if member.partitioned:
                    member._count_failure(op)
                    raise MemberUnreachable(
                        f"member {member.name!r} is partitioned away",
                        member=member.name)
                # the handoff itself is non-blocking member-side (the
                # router sheds or accepts at ITS door), so it runs
                # inline — the bounded-call lane is for ops that wait
                submit = (member.router.submit_encode if op == "encode"
                          else member.router.submit_decode)
                fut = submit(payload, deadline_ms, priority=cls,
                             trace=ctx)
            except (MemberUnreachable, ServiceUnavailable,
                    ServiceOverloaded) as e:
                # a member-level refusal is not a federation failure
                # while another member can take the request
                last = e
                continue
            self.admission.attach(cls, fut)
            self._attach_span(fut, ctx, op, cls, member.name, t0)
            self.metrics.counter(f"federation_routed_{cls}").inc()
            self.metrics.counter(
                f"federation_routed_m_{member.name}").inc()
            return fut
        self.admission.release(cls)
        exc = ServiceUnavailable(
            f"no live federation member accepted {op!r} "
            f"({len(self._members)} member(s); last refusal: "
            f"{last!r}) — retry shortly")
        self.flight.note_error(exc)
        raise exc

    # contract: request-path — every reachable raise must be a typed error
    def submit_encode(self, img, deadline_ms: Optional[float] = None,
                      priority: Optional[str] = None) -> Future:
        return self._submit("encode", img, priority, deadline_ms)

    # contract: request-path — every reachable raise must be a typed error
    def submit_decode(self, blob: bytes,
                      deadline_ms: Optional[float] = None,
                      priority: Optional[str] = None) -> Future:
        return self._submit("decode", blob, priority, deadline_ms)

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

    # -- host-sticky sessions ------------------------------------------------

    def open_session(self, side_img,
                     timeout: Optional[float] = 120.0) -> str:
        """Open on ONE member (round-robin over live members) and pin
        the sid there. Sids are globally unique, so the pin table
        needs no member qualifier."""
        assert self._started, "start() the federation first"
        budget = 120.0 if timeout is None else float(timeout)
        for _ in range(len(self._members)):
            member = self._pick("_session")
            if member is None:
                break
            try:
                sid = member.call(
                    "session_open",
                    lambda m=member: m.router.open_session(
                        side_img, timeout), budget + 5.0)
            except (MemberUnreachable, ServiceUnavailable):
                continue
            with self._lock:
                self._sessions[sid] = member.name
            self.metrics.counter("federation_sessions_opened").inc()
            self._publish_pins()
            return sid
        raise ServiceUnavailable(
            f"no live federation member to open a session on "
            f"({len(self._members)} member(s)) — retry shortly")

    def close_session(self, session_id: str,
                      timeout: Optional[float] = 30.0) -> bool:
        assert self._started, "start() the federation first"
        with self._lock:
            name = self._sessions.pop(session_id, None)
        self._publish_pins()
        if name is None:
            return False
        member = self._members[name]
        try:
            return bool(member.call(
                "session_close",
                lambda: member.router.close_session(session_id,
                                                    timeout),
                (30.0 if timeout is None else timeout) + 5.0))
        except (MemberUnreachable, ServiceUnavailable, ServeError):
            return False    # the pin is dropped either way

    # contract: request-path — every reachable raise must be a typed error
    def submit_decode_si(self, blob: bytes, session_id: str,
                         deadline_ms: Optional[float] = None,
                         priority: Optional[str] = None) -> Future:
        """SI decode against a host-sticky pin. An unknown pin or a
        pinned member that is not currently live answers typed
        `SessionExpired` — the prep exists in one process on one host,
        so 're-open the session' is the only recovery (mirrors the
        router's replica-pin contract exactly, one tier up)."""
        assert self._started, "start() the federation first"
        with self._lock:
            name = self._sessions.get(session_id)
            state = None if name is None else self._state.get(name)
        if name is None or state != "live":
            raise SessionExpired(
                f"session {session_id!r} is not pinned to a live "
                f"federation member ("
                f"{'its member is ' + str(state) if name else 'unknown sid'}"
                f") — re-open it")
        cls = priority or self._class_names[0]
        try:
            self.admission.admit(cls)
        except ServiceOverloaded:
            self.flight.record("shed", reason="admission", cls=cls)
            raise
        ctx = self.tracer.mint(origin="federation")
        t0 = time.monotonic()
        member = self._members[name]
        try:
            if member.partitioned:
                member._count_failure("decode_si")
                raise MemberUnreachable(
                    f"member {name!r} is partitioned away",
                    member=name)
            fut = member.router.submit_decode_si(
                blob, session_id, deadline_ms, priority=cls, trace=ctx)
        except (MemberUnreachable, ServiceUnavailable,
                SessionExpired) as e:
            self.admission.release(cls)
            exc = (e if isinstance(e, SessionExpired) else
                   SessionExpired(
                       f"session {session_id!r}'s member {name!r} is "
                       f"unreachable — its prep lives there; re-open "
                       f"the session ({e})"))
            self.flight.note_error(exc)
            raise exc from e
        self.admission.attach(cls, fut)
        self._attach_span(fut, ctx, "decode_si", cls, name, t0)
        self.metrics.counter(f"federation_routed_{cls}").inc()
        return fut

    def decode_si(self, blob: bytes, session_id: str,
                  deadline_ms: Optional[float] = None,
                  timeout: Optional[float] = 120.0,
                  priority: Optional[str] = None):
        return self.submit_decode_si(blob, session_id, deadline_ms,
                                     priority=priority).result(timeout)

    def _publish_pins(self) -> None:
        with self._lock:
            n = len(self._sessions)
        self.metrics.gauge("federation_sessions_pinned").set(n)

    def _drop_member_pins(self, name: str, reason: str) -> None:
        with self._lock:
            stale = [sid for sid, m in self._sessions.items()
                     if m == name]
            for sid in stale:
                del self._sessions[sid]
        if stale:
            self.metrics.counter(
                f"federation_sessions_dropped_{reason}").inc(len(stale))
        self._publish_pins()

    # -- rollout waves -------------------------------------------------------

    def rollout(self, plan: RolloutPlan,
                health_policy: Optional[Callable[
                    [], FleetHealthPolicy]] = None) -> dict:
        """Promote `plan.ckpt_dir` wave by wave (module docstring).
        Returns {"digest", "waves": [[names...]...], "per_member":
        {name: "committed"}} on full promotion; raises typed
        `RolloutAborted` (after auto-rolling the failing wave — and
        optionally the prior waves — back) on any wave-gate failure.
        `health_policy` builds one fresh soak-window policy per member
        per wave (default: fire fast — 2 consecutive sick checks, no
        cooldown: a soak window exists to catch, not to damp)."""
        assert self._started, "start() the federation before a rollout"
        plan.validate(list(self._members))
        with self._lock:
            if self._rolling:
                raise FederationError(
                    "a rollout is already in flight — one at a time")
            self._rolling = True
        make_policy = health_policy or (
            lambda: FleetHealthPolicy(hysteresis_checks=2,
                                      cooldown_s=0.0))
        try:
            return self._rollout_locked_out(plan, make_policy)
        finally:
            with self._lock:
                self._rolling = False

    def _rollout_locked_out(self, plan: RolloutPlan,
                            make_policy) -> dict:
        per_wave: Dict[int, Dict[str, str]] = {}
        committed: List[Tuple[int, Tuple[str, ...]]] = []
        digest: Optional[str] = None
        self.metrics.counter("federation_rollouts").inc()
        self.rollout_timing = {}
        for w, wave in enumerate(plan.waves):
            per_wave[w] = {}
            timing = self.rollout_timing[w] = {
                "distribute_s": 0.0, "swap_s": 0.0, "canary_gate_s": 0.0,
                "soak_s": 0.0}
            # strict: every wave member must be LIVE at its wave start
            # (promoting onto an evicted/partitioned member would tear
            # the wave's version the moment it heals)
            with self._lock:
                not_live = [n for n in wave
                            if self._state.get(n) != "live"]
            if not_live:
                for n in wave:
                    per_wave[w][n] = ("not live at wave start"
                                      if n in not_live else "untouched")
                self._abort_rollout(plan, per_wave, committed, w,
                                    digest, f"member(s) {not_live} "
                                    f"not live at wave start")
            swapped: List[str] = []
            failed_reason: Optional[str] = None
            for name in wave:
                member = self._members[name]
                try:
                    t0 = time.monotonic()
                    local_dir = self._distribute(plan, member)
                    t1 = time.monotonic()
                    timing["distribute_s"] += t1 - t0
                    res = member.call(
                        "swap",
                        lambda m=member, d=local_dir:
                        m.router.swap_model(
                            d, prepare_timeout_s=plan.swap_timeout_s),
                        plan.swap_timeout_s + 30.0)
                    timing["swap_s"] += time.monotonic() - t1
                except Exception as e:  # noqa: BLE001 — every member-op failure fails the wave typed
                    per_wave[w][name] = f"swap failed: {e}"
                    failed_reason = (f"wave {w} swap failed on "
                                     f"{name!r}: {e}")
                    break
                if digest is None:
                    digest = res["digest"]
                elif res["digest"] != digest:
                    per_wave[w][name] = (
                        f"swap committed digest {res['digest']!r} != "
                        f"rollout digest {digest!r}")
                    swapped.append(name)
                    failed_reason = (f"wave {w} digest disagreement "
                                     f"on {name!r}")
                    break
                per_wave[w][name] = "committed"
                swapped.append(name)
                # a committed member invalidated its session stores
                self._drop_member_pins(name, "rollout")
            if failed_reason is None:
                failed_reason = self._wave_gates(
                    plan, w, wave, digest, make_policy, per_wave)
            if failed_reason is not None:
                self._rollback_wave(plan, w, swapped, digest, per_wave)
                self._abort_rollout(plan, per_wave, committed, w,
                                    digest, failed_reason)
            committed.append((w, wave))
            self.metrics.counter("federation_rollout_waves").inc()
            self.flight.record("rollout_wave", wave=w,
                               members=list(wave), digest=digest)
        self.params_digest = digest
        self.metrics.counter("federation_rollout_promotions").inc()
        return {"digest": digest,
                "waves": [list(wave) for wave in plan.waves],
                "per_member": {n: "committed"
                               for wave in plan.waves for n in wave}}

    def _distribute(self, plan: RolloutPlan, member: Member) -> str:
        """Stage the manifest into the member's own checkpoint root
        (CRC-verified both sides, rotate+rename) and return the dir
        the member swaps from."""
        if not plan.distribute or member.ckpt_root is None:
            return plan.ckpt_dir
        from dsin_tpu_torch.train.checkpoint import replicate_checkpoint

        def _stage():
            replicate_checkpoint(plan.ckpt_dir, member.ckpt_root)
            return member.ckpt_root

        return member.call("distribute", _stage, plan.swap_timeout_s)

    def _member_quality(self, member: Member) -> Optional[dict]:
        """One bounded scrape -> the member's aggregated snapshot, or
        None (unreachable — the gate decides what that means)."""
        try:
            return member.call("scrape",
                               member.router.aggregate.snapshot,
                               self.health_timeout_s
                               + member.router.health_timeout_s)
        except Exception:  # noqa: BLE001 — a dead scrape is data
            return None

    def _wave_gates(self, plan: RolloutPlan, w: int,
                    wave: Tuple[str, ...], digest: Optional[str],
                    make_policy, per_wave) -> Optional[str]:
        """Canary gate + soak window for one committed wave; returns
        the failure reason or None (wave passes)."""
        # -- canary gate: the golden-canary prober must probe the NEW digest
        # through each wave member's real serve path
        timing = self.rollout_timing[w]
        t_gate = time.monotonic()
        deadline = t_gate + plan.canary_timeout_s
        pending = set(wave)
        while pending:
            for name in sorted(pending):
                snap = self._member_quality(self._members[name])
                if snap is None:
                    continue    # unreachable: the deadline judges it
                verdict = wave_canary_verdict(
                    snap.get("info", {}).get("quality"), digest)
                if verdict is False:
                    per_wave[w][name] = (f"canary FAILED against "
                                         f"{digest!r}")
                    return (f"wave {w} canary gate: member {name!r} "
                            f"canary failed against {digest!r}")
                if verdict is True:
                    pending.discard(name)
            if not pending:
                break
            if time.monotonic() > deadline:
                for name in sorted(pending):
                    per_wave[w][name] = "canary verdict never covered " \
                                        "the new digest"
                return (f"wave {w} canary gate timed out after "
                        f"{plan.canary_timeout_s}s waiting on "
                        f"{sorted(pending)}")
            time.sleep(plan.poll_s)
        timing["canary_gate_s"] = time.monotonic() - t_gate
        # -- soak window: fleet-health evidence per member
        if plan.soak_s <= 0:
            return None
        policies = {name: make_policy() for name in wave}
        t_soak = time.monotonic()
        soak_end = t_soak + plan.soak_s
        while time.monotonic() < soak_end:
            for name in wave:
                snap = self._member_quality(self._members[name])
                if snap is None:
                    continue    # partition mid-soak: the poll loop
                    # evicts it; the NEXT wave's liveness check (or
                    # the operator) owns that — a silent member is
                    # not health EVIDENCE against the model
                reason = policies[name].observe(
                    time.monotonic(), health_from_snapshot(snap))
                if reason is not None:
                    per_wave[w][name] = (f"soak health fired "
                                         f"({reason})")
                    return (f"wave {w} soak window: member {name!r} "
                            f"fleet-health fired ({reason})")
            time.sleep(plan.poll_s)
        timing["soak_s"] = time.monotonic() - t_soak
        return None

    def _rollback_wave(self, plan: RolloutPlan, w: int,
                       swapped: List[str], digest: Optional[str],
                       per_wave) -> None:
        """Auto-rollback one failed wave's committed members,
        CONDITIONALLY (never fight a member-local driver)."""
        if digest is not None:
            with self._lock:
                self._aborted.add(digest)
        for name in swapped:
            per_wave[w][name] = self._rollback_member(
                self._members[name], digest, plan.rollback_timeout_s)
        self.metrics.counter("federation_rollout_wave_rollbacks").inc()

    def _rollback_member(self, member: Member,
                         expect_digest: Optional[str],
                         timeout_s: float) -> str:
        """One member's conditional rollback -> outcome string. An
        unreachable member converges LATER through the healing
        reconcile (the aborted-digest set); any other failure evicts
        the member so the skew machinery re-checks it before it can
        take traffic again."""
        try:
            res = member.call(
                "rollback",
                lambda: member.router.rollback(
                    expect_digest=expect_digest), timeout_s)
        except MemberUnreachable:
            return ("unreachable — reconciles through the aborted-"
                    "digest set on heal")
        except FleetSwapError as e:
            with self._lock:
                if self._state.get(member.name) == "live":
                    self._state[member.name] = "evicted"
                    self.metrics.counter(
                        "federation_member_evictions").inc()
            self.flight.note_error(e)
            return f"rollback failed (member evicted): {e}"
        except Exception as e:  # noqa: BLE001 — recorded, member evicted below
            with self._lock:
                if self._state.get(member.name) == "live":
                    self._state[member.name] = "evicted"
            self.flight.note_error(e)
            return f"rollback failed (member evicted): {e}"
        self._drop_member_pins(member.name, "rollback")
        # the digest the member answered is its serving digest now: the
        # last poll's may name the model it just left, and rollback()
        # re-learns the federation's digest from these (the JAX package
        # keeps the poll's until the next one)
        if res.get("digest") is not None:
            with self._lock:
                self._digests[member.name] = res["digest"]
        if res.get("skipped") and not res.get("replicas"):
            return "already converged (conditional rollback skipped)"
        return f"rolled back to {res.get('digest')!r}"

    def _abort_rollout(self, plan: RolloutPlan, per_wave, committed,
                       wave_idx: int, digest: Optional[str],
                       reason: str) -> None:
        """Finish a failed rollout: optionally roll prior committed
        waves back, then raise typed. The promoted-then-aborted digest
        always enters the reconcile set FIRST — a partitioned member
        that committed it before the abort must converge on heal even
        when the failing wave itself had nothing to roll back."""
        if digest is not None:
            with self._lock:
                self._aborted.add(digest)
        if plan.rollback_prior_waves:
            for w, wave in reversed(committed):
                for name in wave:
                    per_wave.setdefault(w, {})[name] = \
                        self._rollback_member(
                            self._members[name], digest,
                            plan.rollback_timeout_s)
        elif committed:
            for w, wave in committed:
                for name in wave:
                    per_wave.setdefault(w, {})[name] = \
                        "committed (prior wave kept by plan)"
        self.metrics.counter("federation_rollout_aborts").inc()
        exc = RolloutAborted(
            f"rollout aborted at wave {wave_idx}: {reason} — the wave "
            f"was rolled back conditionally"
            + (", prior waves too" if plan.rollback_prior_waves
               and committed else
               f", {len(committed)} prior wave(s) kept"),
            digest=digest, wave=wave_idx, reason=reason,
            per_wave=per_wave)
        self.flight.note_error(exc)
        self.flight.record("rollout_abort", wave=wave_idx,
                           reason=reason, digest=digest)
        raise exc

    # -- federation-wide conditional rollback --------------------------------

    def rollback(self, expect_digest: Optional[str] = None,
                 timeout_s: float = 60.0) -> dict:
        """Roll EVERY live member back (the federation-health driver's
        action, and an operator surface). Conditional per member when
        `expect_digest` is given — a member already off the sick
        digest counts converged. Returns {"digest", "rolled",
        "skipped", "failed": {name: outcome}}."""
        assert self._started, "start() the federation first"
        if expect_digest is not None:
            with self._lock:
                self._aborted.add(expect_digest)
        with self._lock:
            live = [n for n, s in self._state.items() if s == "live"]
        rolled, skipped, failed = [], [], {}
        for name in sorted(live):
            outcome = self._rollback_member(
                self._members[name], expect_digest, timeout_s)
            if outcome.startswith("rolled back"):
                rolled.append(name)
            elif outcome.startswith("already converged"):
                skipped.append(name)
            else:
                failed[name] = outcome
        self.metrics.counter("federation_rollbacks").inc()
        # re-learn the federation digest from the survivors
        digests = set()
        for name in rolled + skipped:
            with self._lock:
                d = self._digests.get(name)
            if d is not None and d != expect_digest:
                digests.add(d)
        self.params_digest = (digests.pop() if len(digests) == 1
                              else None)
        return {"digest": self.params_digest, "rolled": rolled,
                "skipped": skipped, "failed": failed}


# -- federation metrics roll-up ------------------------------------

class FederatedMetrics:
    """ONE federation-wide metrics view: the federation's own registry
    merged with a bounded scrape of every member's `AggregatedMetrics`
    roll-up — the same merge rules (shared helpers, serve/metrics.py)
    and the same staleness veto (seq equality + capture age on the
    member snapshot's own top-level `seq`/`captured_at`) the router
    applies to replica scrapes, one tier up. Duck-types the
    `MetricsRegistry` surface (`snapshot()`/`render_text()`)."""

    #: capture-timestamp slack before a member scrape counts as stale
    stale_after_s = 5.0

    def __init__(self, federation: FederatedRouter):
        self._fed = federation
        self._seq_lock = threading.Lock()
        self._last_seq: Dict[str, int] = {}   # guarded-by: self._seq_lock

    def _is_stale(self, name: str, snap: dict, now: float) -> bool:
        """Same verdict as AggregatedMetrics._is_stale: only POSITIVE
        evidence flags a member; the seq test is EQUALITY (a frozen/
        cached response replays the identical seq; a restart going
        backwards is fresh numbers)."""
        seq = snap.get("seq")
        captured = snap.get("captured_at")
        stale = False
        if seq is not None:
            with self._seq_lock:
                prev = self._last_seq.get(name)
                if prev is not None and seq == prev:
                    stale = True
                else:
                    self._last_seq[name] = seq
        if captured is not None and now - captured > self.stale_after_s:
            stale = True
        return stale

    def snapshot(self) -> dict:
        fed = self._fed
        own = fed.metrics.snapshot()
        counters = dict(own["counters"])
        gauges = dict(own["gauges"])
        accumulators = dict(own["accumulators"])
        hist = metrics_lib.hist_partials(own["histograms"])
        names = sorted(fed._members)

        def _safe_scrape(name):
            return fed._member_quality(fed._members[name])

        # concurrent fan-out: N partitioned members must cost ~one
        # bounded timeout total, not N in series
        with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
            snaps = list(pool.map(_safe_scrape, names))
        now = time.time()
        with fed._lock:
            member_states = dict(fed._state)
            member_digests = dict(fed._digests)
        per_member: Dict[str, dict] = {}
        unreachable: List[str] = []
        stale: List[str] = []
        member_errors: Dict[str, dict] = {}
        canary: Dict[str, Any] = {}
        canary_failing: List[str] = []
        for name, snap in zip(names, snaps):
            if snap is None:
                unreachable.append(name)
                continue
            if self._is_stale(name, snap, now):
                stale.append(name)
                continue
            metrics_lib.merge_numeric_sections(
                counters, gauges, accumulators, hist, snap)
            info = snap.get("info", {})
            per_member[name] = info
            q = info.get("quality", {})
            ok = q.get("fleet_canary_ok")
            canary[name] = {
                "fleet_canary_ok": ok,
                "replicas_canary_failing":
                    q.get("replicas_canary_failing", []),
            }
            if ok is False:
                canary_failing.append(name)
            # member-level typed-error window evidence: the federation
            # health driver needs the SKEW across MEMBERS, so each
            # member's per-replica counters sum into one member window
            errs = q.get("replica_errors", {})
            member_errors[name] = {
                "typed_errors": sum(e.get("typed_errors", 0)
                                    for e in errs.values()),
                "resolved": sum(e.get("resolved", 0)
                                for e in errs.values()),
            }
        reported = [n for n in canary
                    if canary[n]["fleet_canary_ok"] is not None]
        return {
            "info": {
                "federation": own["info"],
                "member_digests": member_digests,
                "member_states": member_states,
                "per_member": per_member,
                "members_scraped": len(per_member),
                "members_unreachable": unreachable,
                "members_stale": stale,
                "quality": {
                    "canary": canary,
                    "members_canary_failing": sorted(canary_failing),
                    "federation_canary_ok": ((not canary_failing)
                                             if reported else None),
                    "member_errors": member_errors,
                },
            },
            "counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "accumulators": dict(sorted(accumulators.items())),
            "histograms": metrics_lib.fold_hist_partials(hist),
            "seq": own.get("seq"),
            "captured_at": own.get("captured_at"),
        }

    def render_text(self) -> str:
        return metrics_lib.render_snapshot_text(self.snapshot())


# -- federation trace stitching ------------------------------------

class FederatedTraces:
    """ONE federation-wide trace view: the federation's own span ring
    merged with every member's (already replica-merged) trace view —
    one trace id follows a request federation -> router -> replica on
    one wall-clock timeline. Mirrors `AggregatedTraces`' semantics:
    fresh fan-out per call, unreachable members reported, bounded +
    concurrent so dead members cost ~one timeout total."""

    def __init__(self, federation: FederatedRouter):
        self._fed = federation

    def snapshot(self, trace_id: Optional[str] = None) -> dict:
        fed = self._fed
        own = fed.tracer.snapshot(trace_id=trace_id)
        names = sorted(fed._members)

        def _safe(name):
            member = fed._members[name]
            try:
                return member.call(
                    "trace_scrape",
                    lambda: member.router.traces.snapshot(trace_id),
                    fed.health_timeout_s
                    + member.router.health_timeout_s)
            except Exception:  # noqa: BLE001 — a dead scrape is data
                return None

        parts = [own]
        unreachable: List[str] = []
        scraped = 0
        with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
            snaps = list(pool.map(_safe, names))
        for name, snap in zip(names, snaps):
            if snap is None:
                unreachable.append(name)
                continue
            scraped += 1
            parts.append(snap)
        return {
            "spans": trace_lib.merge_trace_snapshots(parts),
            "federation_spans": len(own["spans"]),
            "members_scraped": scraped,
            "members_unreachable": unreachable,
            "flight": fed.flight.meta(),
        }

    def http_snapshot(self, params: Mapping[str, str]) -> object:
        snap = self.snapshot(trace_id=params.get("id"))
        if params.get("format") == "chrome":
            return trace_lib.chrome_trace(snap["spans"])
        return snap
