"""The fleet's control loop (a copy of the JAX package's
`serve/autoscale.py`, in PyTorch's idiom): signal-driven autoscaling and
the fleet-level health rollback over the port's `FrontDoorRouter`.

* **AutoscalePolicy** — a PURE windowed scale decision (hysteresis
  streaks and cooldowns, no locks, no I/O). Each check consumes one
  `ScaleSignals` observation (per-live-replica outstanding depth, the
  admission-shed delta, per-class p99 against its SLO, stale telemetry)
  and answers +1 (add a replica), -1 (drain one) or 0. Pressure must hold
  for `hysteresis_checks` consecutive checks before a scale-up, idleness
  for `idle_checks` before a drain, and no two scale ops land closer than
  their cooldowns: a replica start costs a spawn and a warmup. Stale
  replica telemetry vetoes drains.

* **FleetHealthPolicy** — the fleet-level rollback decision, also pure.
  A sick MODEL looks the same on every replica; a sick REPLICA does not.
  So it fires only on unanimous evidence: every live, canary-reporting
  replica's golden canary failing, or every live replica's typed-error
  window elevated with bounded skew (max/mean <= `max_error_skew`; one
  bad replica is its own RollbackWatchdog's job).

* **Autoscaler** — the loop that acts on both: a daemon thread samples
  the router's `AggregatedMetrics.snapshot()` every `check_every_s`
  (`tick()` is directly callable, the clock injectable), derives the
  signals with the pure `signals_from_snapshot` / `health_from_snapshot`
  and calls `router.add_replica()` / `router.drain_replica()` /
  `router.rollback(expect_digest=<sick digest>)`. The rollback is
  conditional per replica, so a replica whose own watchdog already rolled
  back is skipped, never fought. Every action and every failed action
  lands in the router's flight recorder and the `serve_autoscale_*`
  counters.

* **FederationHealthDriver** — the same health rule one tier up, over a
  `FederatedRouter`'s roll-up (`federation_health_from_snapshot`),
  driving the federation's conditional rollback.

Locks: `threading.Lock` stands where the JAX package ranks its
`serve.autoscale` lock. It guards only the in-flight-tick flag and is
taken outside every router lock; no router or federation call runs under
it. The policies take no lock: one control thread (or a test) drives
them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional


class AutoscaleError(ValueError):
    """Bad autoscaler configuration (thresholds that cannot decide,
    bounds that cross) — typed so CLIs answer it readably."""


@dataclass(frozen=True)
class AutoscaleConfig:
    """Policy knobs. Watermarks are PER LIVE REPLICA outstanding depth
    (queued + in-flight, the router's occupancy roll-up), so the same
    config scales any fleet size."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: control-loop period (the Autoscaler thread; the policy itself
    #: is clocked by whoever calls observe())
    check_every_s: float = 2.0
    #: scale-up pressure: outstanding depth per live replica at/above
    #: this, OR any admission shed in the window, OR a p99 SLO breach
    outstanding_high: float = 8.0
    #: drain-down idleness: outstanding per live replica at/below this
    #: with zero sheds and no SLO breach
    outstanding_low: float = 1.0
    #: admission sheds in one window that count as pressure
    shed_high: int = 1
    #: per-class p99 SLOs in ms (e.g. {"interactive": 1500.0}); None =
    #: latency does not drive scaling
    slo_ms: Optional[Mapping[str, float]] = None
    #: consecutive pressured checks before a scale-up fires
    hysteresis_checks: int = 2
    #: consecutive idle checks before a drain fires (deliberately
    #: slower than up: over-capacity is cheap, under-capacity sheds)
    idle_checks: int = 5
    up_cooldown_s: float = 10.0
    down_cooldown_s: float = 60.0


@dataclass(frozen=True)
class ScaleSignals:
    """One observation of the fleet, as the policy sees it."""

    live_replicas: int
    #: fleet-wide outstanding depth (router in-flight + replica queues)
    outstanding: float
    #: CUMULATIVE admission sheds (the policy differences consecutive
    #: observations into a window)
    sheds_total: int = 0
    #: per-class p99 latency ms (fleet-wide max, the aggregate's view)
    p99_ms: Mapping[str, float] = field(default_factory=dict)
    #: replicas whose telemetry the aggregate flagged frozen — a drain
    #: veto (never shrink on numbers that might be stale)
    stale_replicas: int = 0


@dataclass(frozen=True)
class FleetHealthSignals:
    """One observation of fleet model-health, as the policy sees it."""

    live_replicas: int
    #: live replicas whose golden canary currently reports "failed"
    canary_failing: int
    #: live replicas reporting ANY canary verdict (a fleet without the
    #: prober configured must never fire on vacuous unanimity)
    canary_reporting: int
    #: CUMULATIVE per-replica (typed_errors, resolved) counters — the
    #: policy differences them into per-replica window rates
    replica_errors: Mapping[str, Mapping[str, int]] = field(
        default_factory=dict)


# contract: pure — replayable policy math
class AutoscalePolicy:
    """Pure windowed scale decision with hysteresis + cooldown (no
    locks: single-caller by contract — the Autoscaler's one thread)."""

    def __init__(self, config: Optional[AutoscaleConfig] = None):
        cfg = config or AutoscaleConfig()
        if cfg.min_replicas < 1:
            raise AutoscaleError(
                f"min_replicas must be >= 1, got {cfg.min_replicas}")
        if cfg.max_replicas < cfg.min_replicas:
            raise AutoscaleError(
                f"max_replicas {cfg.max_replicas} < min_replicas "
                f"{cfg.min_replicas}")
        if cfg.outstanding_low > cfg.outstanding_high:
            raise AutoscaleError(
                f"outstanding_low {cfg.outstanding_low} above "
                f"outstanding_high {cfg.outstanding_high} — the policy "
                f"could be pressured and idle at once")
        if cfg.hysteresis_checks < 1 or cfg.idle_checks < 1:
            raise AutoscaleError(
                f"hysteresis_checks/idle_checks must be >= 1, got "
                f"{cfg.hysteresis_checks}/{cfg.idle_checks}")
        if cfg.up_cooldown_s < 0 or cfg.down_cooldown_s < 0:
            raise AutoscaleError(
                f"cooldowns must be >= 0, got {cfg.up_cooldown_s}/"
                f"{cfg.down_cooldown_s}")
        self.cfg = cfg
        self._up_streak = 0            # contract: state (hysteresis)
        self._idle_streak = 0          # contract: state (hysteresis)
        self._last_scale: Optional[float] = None   # contract: state
        self._last_sheds: Optional[int] = None     # contract: state
        #: last check's classification, for gauges/debugging
        self.last_verdict: Dict[str, Any] = {}     # contract: state

    def observe(self, now: float, sig: ScaleSignals) -> int:
        """One check -> +1 (scale up), -1 (drain), 0 (hold)."""
        shed_delta = (0 if self._last_sheds is None
                      else max(0, sig.sheds_total - self._last_sheds))
        self._last_sheds = sig.sheds_total
        per = sig.outstanding / max(1, sig.live_replicas)
        slo_breach = any(
            sig.p99_ms.get(cls, 0.0) > slo
            for cls, slo in (self.cfg.slo_ms or {}).items())
        pressure = (shed_delta >= self.cfg.shed_high
                    or per >= self.cfg.outstanding_high
                    or slo_breach)
        idle = (not pressure and shed_delta == 0
                and per <= self.cfg.outstanding_low
                and sig.stale_replicas == 0)
        if pressure:
            self._idle_streak = 0
            self._up_streak += 1
        elif idle:
            self._up_streak = 0
            self._idle_streak += 1
        else:
            self._up_streak = 0
            self._idle_streak = 0
        self.last_verdict = {
            "per_replica_outstanding": round(per, 3),
            "shed_delta": shed_delta, "slo_breach": slo_breach,
            "pressure": pressure, "idle": idle,
            "up_streak": self._up_streak,
            "idle_streak": self._idle_streak,
        }
        since = (None if self._last_scale is None
                 else now - self._last_scale)
        if (pressure and self._up_streak >= self.cfg.hysteresis_checks
                and sig.live_replicas < self.cfg.max_replicas
                and (since is None or since >= self.cfg.up_cooldown_s)):
            self._up_streak = 0
            self._last_scale = now
            return 1
        if (idle and self._idle_streak >= self.cfg.idle_checks
                and sig.live_replicas > self.cfg.min_replicas
                and (since is None
                     or since >= self.cfg.down_cooldown_s)):
            self._idle_streak = 0
            self._last_scale = now
            return -1
        return 0

    def note_scale_failed(self, decision: int) -> None:
        """The router refused or failed the op the last decision asked
        for (a swap in flight, a spawn failure): a scale that never
        happened must not consume the hysteresis streak or start a
        cooldown — undo both so the next check under the same
        conditions may fire again immediately, instead of shedding
        load for a whole re-accumulation + cooldown window."""
        self._last_scale = None
        if decision > 0:
            self._up_streak = self.cfg.hysteresis_checks
        elif decision < 0:
            self._idle_streak = self.cfg.idle_checks


# contract: pure — replayable policy math
class FleetHealthPolicy:
    """Pure fleet-level rollback decision: fire only when the COMMITTED
    model is sick on EVERY live replica (unanimous canary failure, or a
    uniformly elevated typed-error rate with bounded cross-replica
    skew). A single sick replica never fires — that is its own
    RollbackWatchdog's jurisdiction."""

    def __init__(self, hysteresis_checks: int = 2,
                 cooldown_s: float = 60.0,
                 error_rate_high: float = 0.5,
                 min_window_resolved: int = 4,
                 max_error_skew: float = 3.0):
        if hysteresis_checks < 1:
            raise AutoscaleError(
                f"hysteresis_checks must be >= 1, got {hysteresis_checks}")
        if not 0.0 < error_rate_high <= 1.0:
            raise AutoscaleError(
                f"error_rate_high must be in (0, 1], got {error_rate_high}")
        if min_window_resolved < 1 or max_error_skew < 1.0:
            raise AutoscaleError(
                f"bad health policy config: min_window_resolved="
                f"{min_window_resolved}, max_error_skew={max_error_skew}")
        self.hysteresis_checks = int(hysteresis_checks)
        self.cooldown_s = float(cooldown_s)
        self.error_rate_high = float(error_rate_high)
        self.min_window_resolved = int(min_window_resolved)
        self.max_error_skew = float(max_error_skew)
        self._canary_streak = 0        # contract: state (hysteresis)
        self._error_streak = 0         # contract: state (hysteresis)
        self._last_fire: Optional[float] = None    # contract: state
        self._last_errors: Dict[str, Mapping[str, int]] = {}   # contract: state

    def observe(self, now: float,
                sig: FleetHealthSignals) -> Optional[str]:
        """One check -> the firing reason ('canary' / 'error_rate') or
        None. Hysteresis per signal; one shared cooldown."""
        # unanimous canary: every live replica reports, every one fails
        unanimous_canary = (
            sig.live_replicas > 0
            and sig.canary_reporting >= sig.live_replicas
            and sig.canary_failing >= sig.live_replicas)
        self._canary_streak = (self._canary_streak + 1
                               if unanimous_canary else 0)
        # typed-error windows: difference the cumulative counters
        rates = []
        enough = bool(sig.replica_errors)
        for idx, cur in sig.replica_errors.items():
            prev = self._last_errors.get(idx, {})
            de = max(0, cur.get("typed_errors", 0)
                     - prev.get("typed_errors", 0))
            dr = max(0, cur.get("resolved", 0) - prev.get("resolved", 0))
            if dr < self.min_window_resolved:
                enough = False
                continue
            rates.append(de / dr)
        self._last_errors = {i: dict(v)
                             for i, v in sig.replica_errors.items()}
        uniform_sick = False
        if enough and rates and len(rates) >= sig.live_replicas:
            mean = sum(rates) / len(rates)
            skew = (max(rates) / mean) if mean > 0 else 1.0
            uniform_sick = (min(rates) >= self.error_rate_high
                            and skew <= self.max_error_skew)
        self._error_streak = (self._error_streak + 1
                              if uniform_sick else 0)
        if (self._last_fire is not None
                and now - self._last_fire < self.cooldown_s):
            return None
        if self._canary_streak >= self.hysteresis_checks:
            self._canary_streak = self._error_streak = 0
            self._last_fire = now
            return "canary"
        if self._error_streak >= self.hysteresis_checks:
            self._canary_streak = self._error_streak = 0
            self._last_fire = now
            return "error_rate"
        return None


# -- snapshot -> signals (pure, shape-tolerant) -------------------------------

# contract: pure
def signals_from_snapshot(snap: Mapping[str, Any]) -> ScaleSignals:
    """Derive the scale policy's inputs from one AggregatedMetrics
    snapshot (serve/router.py): the `replica_occupancy` info roll-up
    is the primary source; shed counters and the
    per-class p99 histograms ride the generic sections."""
    info = snap.get("info", {})
    occ = info.get("replica_occupancy", {})
    live = sum(1 for e in occ.values() if e.get("state") == "live")
    outstanding = 0.0
    for entry in occ.values():
        if entry.get("state") != "live":
            continue
        # the router-side outstanding count ALREADY contains every
        # request sitting in the replica's own queue (it is everything
        # dispatched and unanswered) — adding the scraped queue_depth
        # on top would double-count queued work and scale up at half
        # the intended pressure
        outstanding += float(entry.get("outstanding") or 0)
    sheds = sum(v for k, v in snap.get("counters", {}).items()
                if k.startswith("serve_shed_admission_"))
    p99 = {k[len("serve_latency_ms_"):]: s.get("p99", 0.0)
           for k, s in snap.get("histograms", {}).items()
           if k.startswith("serve_latency_ms_")}
    return ScaleSignals(
        live_replicas=live, outstanding=outstanding,
        sheds_total=int(sheds), p99_ms=p99,
        stale_replicas=len(info.get("replicas_stale", [])))


# contract: pure
def health_from_snapshot(snap: Mapping[str, Any]) -> FleetHealthSignals:
    """Derive the health policy's inputs from one AggregatedMetrics
    snapshot: the quality roll-up's per-replica canary verdicts and
    typed-error counters, restricted to LIVE replicas (an evicted or
    draining replica's sickness is not fleet evidence)."""
    info = snap.get("info", {})
    states = info.get("replica_states", {})
    live_idx = {i for i, s in states.items() if s == "live"}
    quality = info.get("quality", {})
    canary = {i: v for i, v in quality.get("canary", {}).items()
              if i in live_idx}
    failing = [i for i in quality.get("replicas_canary_failing", [])
               if str(i) in live_idx]
    errors = {i: v for i, v in quality.get("replica_errors", {}).items()
              if i in live_idx}
    return FleetHealthSignals(
        live_replicas=len(live_idx),
        canary_failing=len(failing),
        canary_reporting=len(canary),
        replica_errors=errors)


# -- the control loop ---------------------------------------------------------

class Autoscaler:
    """The loop that closes it: sample the fleet, decide, mutate.

    `router` is a started FrontDoorRouter. `snapshot_fn` (default: the
    router's fleet-merged `aggregate.snapshot`) is injectable so tests
    drive the loop on synthetic snapshots; `tick()` runs exactly one
    iteration synchronously for the same reason. `start()` spawns the
    daemon control thread; `stop()` joins it. A tick that throws is
    COUNTED (`serve_autoscale_errors`) and recorded in the flight ring,
    never allowed to kill the loop: a scaler that dies silently is an
    outage multiplier."""

    def __init__(self, router, config: Optional[AutoscaleConfig] = None,
                 policy: Optional[AutoscalePolicy] = None,
                 health_policy: Optional[FleetHealthPolicy] = None,
                 snapshot_fn: Optional[Callable[[], dict]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.router = router
        self.cfg = config or AutoscaleConfig()
        self.policy = policy or AutoscalePolicy(self.cfg)
        #: None = scaling only (the health driver needs the quality
        #: roll-up flowing, which needs canary-enabled replicas)
        self.health_policy = health_policy
        self._snapshot_fn = (snapshot_fn if snapshot_fn is not None
                             else router.aggregate.snapshot)
        self._clock = clock
        self.metrics = router.metrics
        self.flight = router.flight
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ticking = False             # guarded-by: self._lock

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.check_every_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must live
                self.metrics.counter("serve_autoscale_errors").inc()
                self.flight.record("autoscale_error",
                                   error=f"{type(e).__name__}: {e}")

    # -- one control iteration ----------------------------------------------

    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One sample -> decide -> act iteration; returns what happened
        (tests and operators read it; the loop discards it). Serialized
        against itself: a slow tick (a scale op IS slow — spawn + warm)
        must not stack a second one behind it."""
        with self._lock:
            if self._ticking:
                return {"skipped": "tick in flight"}
            self._ticking = True
        try:
            return self._tick_locked_out(self._clock()
                                         if now is None else now)
        finally:
            with self._lock:
                self._ticking = False

    def _tick_locked_out(self, now: float) -> Dict[str, Any]:
        snap = self._snapshot_fn()
        out: Dict[str, Any] = {"action": None, "rollback": None}
        # health first: scaling a sick model up just multiplies the
        # sickness — and a fired rollback makes this tick's scale
        # signals stale anyway
        if self.health_policy is not None:
            reason = self.health_policy.observe(
                now, health_from_snapshot(snap))
            if reason is not None:
                out["rollback"] = self._drive_rollback(reason)
                return out
        sig = signals_from_snapshot(snap)
        decision = self.policy.observe(now, sig)
        self.metrics.gauge("serve_autoscale_outstanding").set(
            sig.outstanding)
        if decision > 0:
            out["action"] = self._scale_up()
        elif decision < 0:
            out["action"] = self._scale_down()
        return out

    def _scale_up(self) -> Dict[str, Any]:
        self.flight.record("autoscale_decision", action="up")
        try:
            info = self.router.add_replica()
        except Exception as e:  # noqa: BLE001 — counted, loop lives
            self.metrics.counter("serve_autoscale_errors").inc()
            self.flight.record("autoscale_error", action="up",
                               error=f"{type(e).__name__}: {e}")
            # the scale never happened: give the policy its streak and
            # cooldown back so sustained pressure can retry immediately
            self.policy.note_scale_failed(1)
            return {"up": None, "error": str(e)}
        self.metrics.counter("serve_autoscale_ups").inc()
        return {"up": info.get("replica")}

    def _scale_down(self) -> Dict[str, Any]:
        self.flight.record("autoscale_decision", action="down")
        try:
            info = self.router.drain_replica()
        except Exception as e:  # noqa: BLE001 — counted, loop lives
            self.metrics.counter("serve_autoscale_errors").inc()
            self.flight.record("autoscale_error", action="down",
                               error=f"{type(e).__name__}: {e}")
            self.policy.note_scale_failed(-1)
            return {"down": None, "error": str(e)}
        self.metrics.counter("serve_autoscale_downs").inc()
        return {"down": info.get("replica")}

    def _drive_rollback(self, reason: str) -> Dict[str, Any]:
        """The fleet is unanimously sick on the COMMITTED model: drive
        the existing two-phase rollback, conditional on the sick digest
        so a replica whose own watchdog already rolled back is skipped,
        not fought."""
        sick = self.router.params_digest
        if sick is None:
            # the fleet digest is UNKNOWN (an all-skipped conditional
            # rollback whose re-learn polls failed): an unconditional
            # rollback here would ping-pong already-converged replicas
            # back onto their prev — possibly the sick — bundle. Wait
            # for the health poller to re-learn the digest instead.
            self.metrics.counter("serve_autoscale_errors").inc()
            self.flight.record(
                "autoscale_error", action="rollback",
                error="fleet digest unknown — refusing an "
                      "unconditional fleet rollback")
            return {"reason": reason, "error": "fleet digest unknown"}
        self.flight.record("fleet_rollback", reason=reason, digest=sick)
        try:
            res = self.router.rollback(expect_digest=sick)
        except Exception as e:  # noqa: BLE001 — counted, loop lives
            self.metrics.counter("serve_autoscale_errors").inc()
            self.flight.record("autoscale_error", action="rollback",
                               error=f"{type(e).__name__}: {e}")
            return {"reason": reason, "error": str(e)}
        self.metrics.counter("serve_autoscale_fleet_rollbacks").inc()
        return {"reason": reason, "rolled_back_from": sick,
                "digest": res.get("digest"),
                "replicas": res.get("replicas"),
                "skipped": res.get("skipped")}


# -- federation tier ----------------------------------------------------------

# contract: pure
def federation_health_from_snapshot(
        snap: Mapping[str, Any]) -> FleetHealthSignals:
    """Derive health-policy inputs from one FederatedMetrics snapshot
    (serve/federation.py) — the same signal shape one tier up: members
    stand where replicas stood. Restricted to LIVE members (an evicted
    or partitioned member's sickness is not federation evidence), and
    each member's canary verdict is its own fleet-level roll-up
    (`fleet_canary_ok`), so 'unanimous' here means EVERY live member's
    ENTIRE fleet agrees the model is sick."""
    info = snap.get("info", {})
    states = info.get("member_states", {})
    live = {n for n, s in states.items() if s == "live"}
    quality = info.get("quality", {})
    canary = {n: v for n, v in quality.get("canary", {}).items()
              if n in live and isinstance(v, dict)
              and v.get("fleet_canary_ok") is not None}
    failing = [n for n in quality.get("members_canary_failing", [])
               if n in live]
    errors = {n: v for n, v in quality.get("member_errors", {}).items()
              if n in live}
    return FleetHealthSignals(
        live_replicas=len(live),
        canary_failing=len(failing),
        canary_reporting=len(canary),
        replica_errors=errors)


class FederationHealthDriver:
    """The fleet-health rollback loop lifted to the federation tier:
    sample the FEDERATED roll-up, run the same unanimous-evidence
    `FleetHealthPolicy` over member-level signals, and on a fire drive
    the federation's CONDITIONAL rollback (`expect_digest=<sick>`) —
    every member already converged by its own driver/watchdog refuses
    typed and is counted, never fought. This is the backstop BEHIND the
    rollout machinery: waves catch a sick model during promotion; this
    loop catches one that soaked clean and went sick later, fleet-wide.

    Mirrors `Autoscaler`'s shape (injectable snapshot_fn + clock,
    synchronous `tick()`, daemon loop that counts its own errors and
    never dies). Holds no lock while acting: its lock only serializes the
    in-flight-tick flag, and a federation rollback takes the federation's
    lock, which never sits under it."""

    def __init__(self, federation,
                 policy: Optional[FleetHealthPolicy] = None,
                 check_every_s: float = 1.0,
                 snapshot_fn: Optional[Callable[[], dict]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.federation = federation
        self.policy = policy or FleetHealthPolicy()
        self.check_every_s = float(check_every_s)
        self._snapshot_fn = (snapshot_fn if snapshot_fn is not None
                             else federation.aggregate.snapshot)
        self._clock = clock
        self.metrics = federation.metrics
        self.flight = federation.flight
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ticking = False             # guarded-by: self._lock

    def start(self) -> "FederationHealthDriver":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="federation-health",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None

    def __enter__(self) -> "FederationHealthDriver":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.wait(self.check_every_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must live
                self.metrics.counter(
                    "federation_health_driver_errors").inc()
                self.flight.record("federation_health_error",
                                   error=f"{type(e).__name__}: {e}")

    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One sample -> decide -> act iteration (see Autoscaler.tick:
        serialized against itself, a rollback IS slow)."""
        with self._lock:
            if self._ticking:
                return {"skipped": "tick in flight"}
            self._ticking = True
        try:
            return self._tick_locked_out(self._clock()
                                         if now is None else now)
        finally:
            with self._lock:
                self._ticking = False

    def _tick_locked_out(self, now: float) -> Dict[str, Any]:
        snap = self._snapshot_fn()
        reason = self.policy.observe(
            now, federation_health_from_snapshot(snap))
        if reason is None:
            return {"rollback": None}
        sick = self.federation.params_digest
        if sick is None:
            # same refusal as the fleet tier: an unconditional rollback
            # on an UNKNOWN digest would ping-pong converged members
            self.metrics.counter(
                "federation_health_driver_errors").inc()
            self.flight.record(
                "federation_health_error", action="rollback",
                error="federation digest unknown — refusing an "
                      "unconditional federation rollback")
            return {"rollback": {"reason": reason,
                                 "error": "federation digest unknown"}}
        self.flight.record("federation_rollback", reason=reason,
                           digest=sick)
        try:
            res = self.federation.rollback(expect_digest=sick)
        except Exception as e:  # noqa: BLE001 — counted, loop lives
            self.metrics.counter(
                "federation_health_driver_errors").inc()
            self.flight.record("federation_health_error",
                               action="rollback",
                               error=f"{type(e).__name__}: {e}")
            return {"rollback": {"reason": reason, "error": str(e)}}
        self.metrics.counter("federation_health_rollbacks").inc()
        return {"rollback": {"reason": reason,
                             "rolled_back_from": sick, **res}}
