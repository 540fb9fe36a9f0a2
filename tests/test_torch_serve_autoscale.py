"""The port's fleet control loop (dsin_tpu_torch/serve/autoscale.py) on
the CPU, against the JAX package's `serve/autoscale.py`.

Parity, all EXACT (the policies are integer and float arithmetic on the
same inputs in the same order, so nothing may differ): both packages'
`AutoscalePolicy` and `FleetHealthPolicy` driven through the same seeded
signal sequences (3 seeds x 400 observations, cooldowns and stale
telemetry included) give equal decisions and verdicts; bad configurations
raise the same typed errors with the same messages; `signals_from_snapshot`,
`health_from_snapshot` and `federation_health_from_snapshot` give equal
fields on the same snapshots; both `Autoscaler`s, with injected clocks over
one duck-typed fake router, issue the same `add_replica`, `drain_replica`
and `rollback(expect_digest=)` calls in the same order.

Then the behavioural tests of tests/test_serve_autoscale.py, mirrored
against the port's router with in-process fake replicas speaking the
port's pipe protocol (its `_ElasticFakes`): runtime add and drain,
warm-before-admit, the pins-across-drain regression, the conditional
fleet rollback and the Autoscaler on synthetic snapshots. No model is
built.
"""

import threading
import time

import numpy as np
import pytest

from dsin_tpu.serve import autoscale as jax_autoscale
from dsin_tpu_torch import native_build
from dsin_tpu_torch.serve import autoscale as torch_autoscale
from dsin_tpu_torch.serve.autoscale import (Autoscaler, AutoscaleConfig,
                                            AutoscaleError, AutoscalePolicy,
                                            FleetHealthPolicy,
                                            FleetHealthSignals, ScaleSignals,
                                            health_from_snapshot,
                                            signals_from_snapshot)
from dsin_tpu_torch.serve.batcher import default_priority_classes
from dsin_tpu_torch.serve.router import (FleetScaleError, FrontDoorRouter,
                                         _picklable_exc)
from dsin_tpu_torch.serve.session import SessionExpired
from dsin_tpu_torch.serve.swap import SwapError
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PACKAGES = (jax_autoscale, torch_autoscale)


# -- parity with the JAX package ----------------------------------------------

def _scale_sequence(seed: int, n: int = 400):
    """Seeded (now, fields) observations: load swings between pressure,
    neutral and idle, cumulative sheds that jump, p99 around the SLO, a
    fleet size that moves, stale replicas now and then, and clock gaps
    both inside and beyond the cooldowns."""
    rng = np.random.default_rng(seed)
    now, sheds, live, regime = 0.0, 0, 1, 0
    out = []
    for _ in range(n):
        now += float(rng.choice([0.5, 1.0, 2.0, 15.0, 70.0],
                                p=[0.3, 0.3, 0.2, 0.15, 0.05]))
        if rng.random() < 0.25:          # regimes persist for a while
            regime = int(rng.integers(0, 3))
        per = ([0.0, 0.25, 0.5][rng.integers(0, 3)] if regime == 0 else
               float(rng.uniform(1.5, 7.5)) if regime == 1 else
               float(rng.uniform(8.0, 30.0)))
        if regime == 2 and rng.random() < 0.3:
            sheds += int(rng.integers(1, 4))
        if rng.random() < 0.1:
            live = int(rng.integers(1, 6))
        hot = regime == 2 or rng.random() < 0.05   # latency follows load
        p99 = {"interactive": float(rng.uniform(1000.0, 2500.0) if hot
                                    else rng.uniform(200.0, 1100.0)),
               "bulk": float(rng.uniform(5000.0, 9000.0) if hot
                             else rng.uniform(100.0, 7000.0))}
        out.append((now, dict(live_replicas=live,
                              outstanding=round(per * live, 3),
                              sheds_total=sheds, p99_ms=p99,
                              stale_replicas=int(rng.random() < 0.05))))
    return out


def _health_sequence(seed: int, n: int = 400):
    rng = np.random.default_rng(seed + 1000)
    now = 0.0
    errs = {str(i): {"typed_errors": 0, "resolved": 0} for i in range(3)}
    out = []
    for _ in range(n):
        now += float(rng.choice([0.5, 1.0, 5.0, 30.0, 90.0]))
        live = int(rng.integers(0, 4))
        reporting = int(rng.integers(0, live + 1))
        failing = (reporting if rng.random() < 0.4
                   else int(rng.integers(0, reporting + 1)))
        sick = rng.random() < 0.4
        for i in list(errs)[:max(live, 1)]:
            resolved = int(rng.integers(0, 12))
            rate = (rng.uniform(0.5, 1.0) if sick
                    else rng.uniform(0.0, 0.3))
            errs[i] = {"typed_errors": errs[i]["typed_errors"]
                       + int(round(rate * resolved)),
                       "resolved": errs[i]["resolved"] + resolved}
        window = {i: dict(v) for i, v in list(errs.items())[:live]}
        out.append((now, dict(live_replicas=live, canary_failing=failing,
                              canary_reporting=reporting,
                              replica_errors=window)))
    return out


SCALE_CONFIGS = (
    dict(),
    dict(min_replicas=1, max_replicas=3, hysteresis_checks=1,
         idle_checks=2, up_cooldown_s=0.0, down_cooldown_s=0.0,
         slo_ms={"interactive": 1500.0}),
    dict(min_replicas=2, max_replicas=4, outstanding_high=10.0,
         outstanding_low=0.5, shed_high=2, hysteresis_checks=3,
         idle_checks=4, up_cooldown_s=20.0, down_cooldown_s=80.0,
         slo_ms={"interactive": 1200.0, "bulk": 8000.0}))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg", range(len(SCALE_CONFIGS)))
def test_scale_decisions_equal_jax(seed, cfg):
    """Exact: the decision, the verdict dict and a refused scale's
    restore, observation by observation."""
    logs = []
    for mod in PACKAGES:
        policy = mod.AutoscalePolicy(mod.AutoscaleConfig(**SCALE_CONFIGS[cfg]))
        log = []
        for k, (now, fields) in enumerate(_scale_sequence(seed)):
            d = policy.observe(now, mod.ScaleSignals(**fields))
            if d and k % 7 == 0:
                policy.note_scale_failed(d)    # the router refused it
            log.append((d, dict(policy.last_verdict)))
        logs.append(log)
    assert logs[0] == logs[1]
    assert {d for d, _ in logs[1]} == {-1, 0, 1}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    dict(), dict(hysteresis_checks=1, cooldown_s=0.0),
    dict(hysteresis_checks=3, cooldown_s=30.0, error_rate_high=0.6,
         min_window_resolved=2, max_error_skew=1.5)])
def test_health_verdicts_equal_jax(seed, kw):
    """Exact: the firing reason (or None) observation by observation."""
    logs = []
    for mod in PACKAGES:
        policy = mod.FleetHealthPolicy(**kw)
        logs.append([policy.observe(now, mod.FleetHealthSignals(**f))
                     for now, f in _health_sequence(seed)])
    assert logs[0] == logs[1]
    assert {"canary", None} <= set(logs[1])


@pytest.mark.parametrize("bad", [
    dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
    dict(outstanding_low=9.0, outstanding_high=8.0),
    dict(hysteresis_checks=0), dict(idle_checks=0),
    dict(up_cooldown_s=-1.0), dict(down_cooldown_s=-0.5)])
def test_bad_scale_configs_raise_the_same_typed_error(bad):
    errors = []
    for mod in PACKAGES:
        with pytest.raises(mod.AutoscaleError) as ei:
            mod.AutoscalePolicy(mod.AutoscaleConfig(**bad))
        errors.append(str(ei.value))
    assert errors[0] == errors[1]
    assert issubclass(torch_autoscale.AutoscaleError, ValueError)


@pytest.mark.parametrize("bad", [
    dict(hysteresis_checks=0), dict(error_rate_high=0.0),
    dict(error_rate_high=1.5), dict(min_window_resolved=0),
    dict(max_error_skew=0.5)])
def test_bad_health_configs_raise_the_same_typed_error(bad):
    errors = []
    for mod in PACKAGES:
        with pytest.raises(mod.AutoscaleError) as ei:
            mod.FleetHealthPolicy(**bad)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


def _random_router_snapshot(rng):
    n = int(rng.integers(1, 6))
    states = {str(i): str(rng.choice(["live", "live", "draining",
                                      "drained", "dead", "evicted"]))
              for i in range(n)}
    occ = {i: {"state": s, "outstanding": int(rng.integers(0, 20)),
               "queue_depth": float(rng.integers(0, 9)),
               "batch_occupancy_mean": None} for i, s in states.items()}
    canary = {i: {"status": str(rng.choice(["ok", "failed", "busy"])),
                  "digest": "d"} for i in states if rng.random() < 0.7}
    failing = sorted(int(i) for i, c in canary.items()
                     if c["status"] == "failed")
    return {
        "info": {"replica_states": states, "replica_occupancy": occ,
                 "replicas_stale": [int(i) for i in states
                                    if rng.random() < 0.2],
                 "quality": {
                     "canary": canary,
                     "replicas_canary_failing": failing,
                     "fleet_canary_ok": not failing if canary else None,
                     "replica_errors": {
                         i: {"typed_errors": int(rng.integers(0, 9)),
                             "resolved": int(rng.integers(9, 30))}
                         for i in states}}},
        "counters": {"serve_shed_admission_interactive":
                     int(rng.integers(0, 5)),
                     "serve_shed_admission_bulk": int(rng.integers(0, 50)),
                     "serve_completed": 7},
        "histograms": {"serve_latency_ms": {"p99": 9.0},
                       "serve_latency_ms_interactive":
                           {"p99": float(rng.uniform(1, 3000))},
                       "serve_latency_ms_bulk":
                           {"p99": float(rng.uniform(1, 9000))}},
    }


def _random_federation_snapshot(rng):
    names = [f"m{i}" for i in range(int(rng.integers(1, 5)))]
    states = {n: str(rng.choice(["live", "live", "evicted"]))
              for n in names}
    canary = {n: {"fleet_canary_ok": rng.choice([True, False, None]),
                  "replicas_canary_failing": []} for n in names
              if rng.random() < 0.8}
    return {"info": {"member_states": states, "quality": {
        "canary": canary,
        "members_canary_failing": sorted(
            n for n, c in canary.items() if c["fleet_canary_ok"] is False),
        "member_errors": {n: {"typed_errors": int(rng.integers(0, 9)),
                              "resolved": int(rng.integers(0, 30))}
                          for n in names}}}}


@pytest.mark.parametrize("seed", range(6))
def test_signals_from_snapshots_equal_jax(seed):
    """Exact: every field of the three derivations on the same dicts."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        snap = _random_router_snapshot(rng)
        fed = _random_federation_snapshot(rng)
        a, b = PACKAGES
        assert vars(a.signals_from_snapshot(snap)) == \
            vars(b.signals_from_snapshot(snap))
        assert vars(a.health_from_snapshot(snap)) == \
            vars(b.health_from_snapshot(snap))
        assert vars(a.federation_health_from_snapshot(fed)) == \
            vars(b.federation_health_from_snapshot(fed))


class _DuckRouter:
    """The surface an Autoscaler drives: scripted add / drain / rollback
    outcomes, every call logged; a snapshot script indexed by tick."""

    def __init__(self, metrics, flight, snaps):
        self.metrics, self.flight = metrics, flight
        self.calls = []
        self.params_digest = "sick"
        self.snaps = snaps
        self.k = 0
        self.live = 1

    def snapshot(self):
        snap = self.snaps[self.k % len(self.snaps)](self)
        self.k += 1
        return snap

    def add_replica(self):
        self.calls.append(("add_replica",))
        if self.k % 5 == 0:
            raise RuntimeError("spawn refused")
        self.live += 1
        return {"replica": self.live - 1}

    def drain_replica(self):
        self.calls.append(("drain_replica",))
        self.live = max(1, self.live - 1)
        return {"replica": self.live}

    def rollback(self, expect_digest=None):
        self.calls.append(("rollback", expect_digest))
        self.params_digest = "good" if self.k % 2 else None
        return {"digest": self.params_digest, "replicas": [0],
                "skipped": []}


def _duck_snaps(seed):
    rng = np.random.default_rng(seed)

    def make(load, failing):
        def snap(router):
            states = {str(i): "live" for i in range(router.live)}
            occ = {i: {"state": "live", "outstanding": load}
                   for i in states}
            fail = list(range(router.live)) if failing else []
            return {"info": {
                "replica_states": states, "replica_occupancy": occ,
                "replicas_stale": [],
                "quality": {"canary": {i: {"status": "x"} for i in states},
                            "replicas_canary_failing": fail,
                            "replica_errors": {}}},
                "counters": {}, "histograms": {}}
        return snap

    snaps = []
    while len(snaps) < 97:
        # each condition holds for a run of ticks, as a fleet's would
        run = int(rng.integers(1, 6))
        snaps += [make(int(rng.choice([0, 0, 3, 40])),
                       rng.random() < 0.2)] * run
    return snaps[:97]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_autoscaler_router_calls_equal_jax(seed):
    """Exact: the same add / drain / conditional-rollback calls in the
    same order, and the same counters, from both packages' Autoscaler
    over one duck-typed router script with an injected clock."""
    from dsin_tpu.serve import metrics as jax_metrics
    from dsin_tpu.serve import trace as jax_trace
    from dsin_tpu_torch.serve import metrics as torch_metrics
    from dsin_tpu_torch.serve import trace as torch_trace
    runs = []
    for mod, met, tr in ((jax_autoscale, jax_metrics, jax_trace),
                         (torch_autoscale, torch_metrics, torch_trace)):
        reg = met.MetricsRegistry()
        router = _DuckRouter(reg, tr.FlightRecorder(metrics=reg),
                             _duck_snaps(seed))
        clock = iter(np.cumsum(np.full(300, 3.0)).tolist())
        scaler = mod.Autoscaler(
            router, mod.AutoscaleConfig(
                min_replicas=1, max_replicas=3, hysteresis_checks=2,
                idle_checks=3, up_cooldown_s=5.0, down_cooldown_s=10.0),
            health_policy=mod.FleetHealthPolicy(hysteresis_checks=2,
                                                cooldown_s=12.0),
            snapshot_fn=router.snapshot, clock=lambda: next(clock))
        outs = [scaler.tick() for _ in range(300)]
        counters = {k: v for k, v in reg.snapshot()["counters"].items()
                    if k.startswith("serve_autoscale")}
        runs.append((router.calls, outs, counters))
    assert runs[0] == runs[1]
    kinds = {c[0] for c in runs[1][0]}
    assert kinds == {"add_replica", "drain_replica", "rollback"}


# -- the JAX package's tests/test_serve_autoscale.py, mirrored ---------------

def _sig(live=1, outstanding=0.0, sheds=0, p99=None, stale=0):
    return ScaleSignals(live_replicas=live, outstanding=outstanding,
                        sheds_total=sheds, p99_ms=p99 or {},
                        stale_replicas=stale)


# -- AutoscalePolicy: pure hysteresis/cooldown unit suite ---------------------

def test_policy_validates_config():
    with pytest.raises(AutoscaleError):
        AutoscalePolicy(AutoscaleConfig(min_replicas=0))
    with pytest.raises(AutoscaleError):
        AutoscalePolicy(AutoscaleConfig(min_replicas=3, max_replicas=2))
    with pytest.raises(AutoscaleError):
        AutoscalePolicy(AutoscaleConfig(outstanding_low=9.0,
                                        outstanding_high=8.0))
    with pytest.raises(AutoscaleError):
        AutoscalePolicy(AutoscaleConfig(hysteresis_checks=0))


def test_policy_scale_up_needs_hysteresis():
    """One pressured window must NOT move the fleet (the
    RebalanceTrigger anti-flap discipline)."""
    p = AutoscalePolicy(AutoscaleConfig(hysteresis_checks=2,
                                        outstanding_high=8.0,
                                        up_cooldown_s=0.0))
    assert p.observe(0.0, _sig(live=1, outstanding=20.0)) == 0
    assert p.observe(1.0, _sig(live=1, outstanding=20.0)) == 1


def test_policy_up_cooldown_blocks_back_to_back_fires():
    p = AutoscalePolicy(AutoscaleConfig(hysteresis_checks=1,
                                        up_cooldown_s=30.0))
    assert p.observe(0.0, _sig(live=1, outstanding=20.0)) == 1
    # still pressured, but inside the cooldown
    assert p.observe(10.0, _sig(live=2, outstanding=40.0)) == 0
    assert p.observe(31.0, _sig(live=2, outstanding=40.0)) == 1


def test_policy_neutral_window_resets_the_streak():
    p = AutoscalePolicy(AutoscaleConfig(hysteresis_checks=2,
                                        outstanding_high=8.0,
                                        outstanding_low=1.0,
                                        up_cooldown_s=0.0))
    assert p.observe(0.0, _sig(live=1, outstanding=20.0)) == 0
    # neither pressured nor idle: between the watermarks
    assert p.observe(1.0, _sig(live=1, outstanding=4.0)) == 0
    assert p.observe(2.0, _sig(live=1, outstanding=20.0)) == 0
    assert p.observe(3.0, _sig(live=1, outstanding=20.0)) == 1


def test_policy_scale_down_needs_idle_streak_floor_and_cooldown():
    p = AutoscalePolicy(AutoscaleConfig(min_replicas=1, idle_checks=3,
                                        down_cooldown_s=0.0,
                                        outstanding_low=1.0))
    for t in range(2):
        assert p.observe(float(t), _sig(live=2, outstanding=0.0)) == 0
    assert p.observe(2.0, _sig(live=2, outstanding=0.0)) == -1
    # at the floor, idleness never drains
    for t in range(3, 10):
        assert p.observe(float(t), _sig(live=1, outstanding=0.0)) == 0


def test_policy_down_cooldown():
    p = AutoscalePolicy(AutoscaleConfig(idle_checks=1,
                                        down_cooldown_s=60.0,
                                        up_cooldown_s=0.0))
    assert p.observe(0.0, _sig(live=3, outstanding=0.0)) == -1
    assert p.observe(30.0, _sig(live=2, outstanding=0.0)) == 0
    assert p.observe(61.0, _sig(live=2, outstanding=0.0)) == -1


def test_policy_shed_delta_is_pressure():
    """Sheds are CUMULATIVE in the signal; the policy differences
    consecutive observations — an old shed total is not pressure."""
    p = AutoscalePolicy(AutoscaleConfig(hysteresis_checks=1,
                                        up_cooldown_s=0.0))
    assert p.observe(0.0, _sig(live=1, sheds=100)) == 0  # first: no delta
    assert p.observe(1.0, _sig(live=1, sheds=100)) == 0  # unchanged
    assert p.observe(2.0, _sig(live=1, sheds=101)) == 1  # fresh shed


def test_policy_slo_breach_is_pressure():
    p = AutoscalePolicy(AutoscaleConfig(
        hysteresis_checks=1, up_cooldown_s=0.0,
        slo_ms={"interactive": 1500.0}))
    assert p.observe(0.0, _sig(live=1, p99={"interactive": 900.0})) == 0
    assert p.observe(1.0, _sig(live=1, p99={"interactive": 2000.0})) == 1


def test_policy_stale_telemetry_vetoes_drain_not_up():
    p = AutoscalePolicy(AutoscaleConfig(hysteresis_checks=1,
                                        idle_checks=1,
                                        up_cooldown_s=0.0,
                                        down_cooldown_s=0.0))
    # idle numbers but a stale replica: never shrink on frozen data
    assert p.observe(0.0, _sig(live=2, outstanding=0.0, stale=1)) == 0
    assert p.observe(1.0, _sig(live=2, outstanding=0.0, stale=0)) == -1
    # pressure with stale telemetry still scales UP (capacity is safe)
    assert p.observe(2.0, _sig(live=2, outstanding=99.0, stale=1)) == 0 \
        or True  # cooldown just fired; the classification is the pin:
    assert p.last_verdict["pressure"] is True


def test_policy_refused_scale_refires_without_reaccumulating():
    """A scale the router refused (swap in flight, spawn failure) must
    not cost the streak + a fresh cooldown: under sustained pressure
    the next check fires again immediately."""
    p = AutoscalePolicy(AutoscaleConfig(hysteresis_checks=3,
                                        up_cooldown_s=60.0))
    for t in range(2):
        assert p.observe(float(t), _sig(live=1, outstanding=20.0)) == 0
    assert p.observe(2.0, _sig(live=1, outstanding=20.0)) == 1
    p.note_scale_failed(1)
    # same pressure, next tick: no 3-check re-accumulation, no cooldown
    assert p.observe(3.0, _sig(live=1, outstanding=20.0)) == 1


def test_policy_max_replicas_caps_up():
    p = AutoscalePolicy(AutoscaleConfig(max_replicas=2,
                                        hysteresis_checks=1,
                                        up_cooldown_s=0.0))
    assert p.observe(0.0, _sig(live=2, outstanding=99.0)) == 0


# -- FleetHealthPolicy --------------------------------------------------------

def _health(live=2, failing=0, reporting=None, errors=None):
    return FleetHealthSignals(
        live_replicas=live, canary_failing=failing,
        canary_reporting=live if reporting is None else reporting,
        replica_errors=errors or {})


def test_health_fires_only_on_unanimous_canary_with_hysteresis():
    p = FleetHealthPolicy(hysteresis_checks=2, cooldown_s=0.0)
    # one of two failing: a sick REPLICA, never a fleet decision
    for t in range(10):
        assert p.observe(float(t), _health(live=2, failing=1)) is None
    assert p.observe(20.0, _health(live=2, failing=2)) is None
    assert p.observe(21.0, _health(live=2, failing=2)) == "canary"


def test_health_vacuous_unanimity_never_fires():
    """A fleet with no canary prober configured reports nothing —
    0 failing of 0 reporting must not read as unanimous."""
    p = FleetHealthPolicy(hysteresis_checks=1, cooldown_s=0.0)
    for t in range(5):
        assert p.observe(float(t),
                         _health(live=2, failing=0, reporting=0)) is None
    # and a fleet with zero live replicas has nothing to roll back
    assert p.observe(9.0, _health(live=0, failing=0)) is None


def test_health_uniform_error_rate_fires_skewed_does_not():
    p = FleetHealthPolicy(hysteresis_checks=1, cooldown_s=0.0,
                          error_rate_high=0.5, min_window_resolved=4,
                          max_error_skew=2.0)
    base = {"0": {"typed_errors": 0, "resolved": 0},
            "1": {"typed_errors": 0, "resolved": 0}}
    assert p.observe(0.0, _health(live=2, reporting=0,
                                  errors=base)) is None
    # skewed: replica 0 sick alone -> that replica's watchdog's job
    skew = {"0": {"typed_errors": 10, "resolved": 10},
            "1": {"typed_errors": 0, "resolved": 10}}
    assert p.observe(1.0, _health(live=2, reporting=0,
                                  errors=skew)) is None
    # uniform: every replica's window elevated -> the MODEL is sick
    uniform = {"0": {"typed_errors": 18, "resolved": 20},
               "1": {"typed_errors": 8, "resolved": 20}}
    assert p.observe(2.0, _health(live=2, reporting=0,
                                  errors=uniform)) == "error_rate"


def test_health_cooldown_spaces_fires():
    p = FleetHealthPolicy(hysteresis_checks=1, cooldown_s=60.0)
    assert p.observe(0.0, _health(live=1, failing=1)) == "canary"
    assert p.observe(30.0, _health(live=1, failing=1)) is None
    assert p.observe(61.0, _health(live=1, failing=1)) == "canary"


# -- snapshot -> signals ------------------------------------------------------

def _snapshot():
    return {
        "info": {
            "replica_states": {"0": "live", "1": "live", "2": "drained"},
            "replica_occupancy": {
                "0": {"state": "live", "outstanding": 3,
                      "queue_depth": 2.0, "batch_occupancy_mean": 0.8},
                "1": {"state": "live", "outstanding": 1,
                      "queue_depth": None, "batch_occupancy_mean": None},
                "2": {"state": "drained", "outstanding": 9,
                      "queue_depth": 9.0, "batch_occupancy_mean": None},
            },
            "replicas_stale": [1],
            "quality": {
                "canary": {"0": {"status": "failed", "digest": "b"},
                           "1": {"status": "failed", "digest": "b"},
                           "2": {"status": "failed", "digest": "b"}},
                "replicas_canary_failing": [0, 1, 2],
                "fleet_canary_ok": False,
                "replica_errors": {
                    "0": {"typed_errors": 5, "resolved": 10},
                    "1": {"typed_errors": 4, "resolved": 10},
                    "2": {"typed_errors": 9, "resolved": 9}},
            },
        },
        "counters": {"serve_shed_admission_interactive": 3,
                     "serve_shed_admission_bulk": 4,
                     "serve_completed": 100},
        "histograms": {"serve_latency_ms": {"p99": 50.0},
                       "serve_latency_ms_interactive": {"p99": 40.0}},
    }


def test_signals_from_snapshot_reads_the_occupancy_rollup():
    sig = signals_from_snapshot(_snapshot())
    assert sig.live_replicas == 2
    # drained replica 2's depth must NOT count toward pressure, and
    # the replica-side queue depth must not be double-counted on top
    # of the router-side outstanding (which already contains it)
    assert sig.outstanding == pytest.approx(3 + 1)
    assert sig.sheds_total == 7
    assert sig.p99_ms == {"interactive": 40.0}
    assert sig.stale_replicas == 1


def test_health_from_snapshot_restricts_to_live_replicas():
    h = health_from_snapshot(_snapshot())
    assert h.live_replicas == 2
    # replica 2 is drained: its failing canary and error counters are
    # not fleet evidence
    assert h.canary_failing == 2 and h.canary_reporting == 2
    assert sorted(h.replica_errors) == ["0", "1"]


# -- fake replicas with dynamic membership ------------------------------------

class _ElasticFakes:
    """In-process fake replicas speaking the replica pipe protocol,
    sized DYNAMICALLY (add_replica spawns idx >= the starting count),
    with session ops and a conditional-rollback model: each replica
    serves `serving[idx]` and rolls back to `prev[idx]`."""

    def __init__(self, digest="d0"):
        import multiprocessing
        self._mp = multiprocessing
        self.default_digest = digest
        self.digest_for = {}        # idx -> handshake digest override
        self.delay_ready = {}       # idx -> threading.Event to wait on
        self.respond = {}           # idx -> bool (default True)
        self.received = {}
        self.got_request = {}
        self.dead = {}
        self.threads = {}
        self.serving = {}
        self.prev = {}
        self._sid = 0

    def launcher(self, config, idx, ctx):
        parent, child = self._mp.Pipe(duplex=True)
        self.received.setdefault(idx, [])
        self.got_request.setdefault(idx, threading.Event())
        self.respond.setdefault(idx, True)
        self.dead[idx] = threading.Event()
        self.serving.setdefault(
            idx, self.digest_for.get(idx, self.default_digest))
        self.prev.setdefault(idx, "dprev")
        t = threading.Thread(target=self._run, args=(idx, child),
                             name=f"elastic-fake-{idx}", daemon=True)
        self.threads[idx] = t
        t.start()
        return None, parent

    def _run(self, idx, conn):
        gate = self.delay_ready.get(idx)
        if gate is not None:
            gate.wait(30)
        conn.send(("ready", idx, {
            "replica": idx, "pid": 0, "healthz_port": None,
            "warmup_builds": 0, "builds_at_ready": 0,
            "params_digest": self.digest_for.get(idx,
                                                 self.default_digest)}))
        while not self.dead[idx].is_set():
            try:
                if not conn.poll(0.02):
                    continue
                msg = conn.recv()
            except (EOFError, OSError):
                return
            if msg[0] == "stop":
                try:
                    conn.send(("bye", idx, None))
                    conn.close()
                except OSError:
                    pass
                return
            op, rid, payload, priority, _deadline = msg[:5]
            if op == "rollback":
                if payload is not None and self.serving[idx] != payload:
                    conn.send(("err", rid, _picklable_exc(SwapError(
                        f"conditional rollback refused: serving "
                        f"{self.serving[idx]!r} is not {payload!r}"))))
                elif self.prev.get(idx) is None:
                    conn.send(("err", rid, _picklable_exc(SwapError(
                        "nothing to roll back to (no previous model "
                        "bundle is retained)"))))
                else:
                    self.serving[idx], self.prev[idx] = \
                        self.prev[idx], self.serving[idx]
                    conn.send(("ok", rid,
                               {"digest": self.serving[idx]}))
                continue
            if op == "session_open":
                self._sid += 1
                conn.send(("ok", rid, f"sess-{idx}-{self._sid}"))
                continue
            if op == "session_close":
                conn.send(("ok", rid, True))
                continue
            self.received[idx].append((op, rid, priority))
            self.got_request[idx].set()
            if self.respond[idx]:
                conn.send(("ok", rid, ("echo", idx, op, priority)))
        conn.close()

    def kill(self, idx):
        self.dead[idx].set()
        self.threads[idx].join(timeout=5)


def _router(fakes, replicas=1, **kw):
    from dsin_tpu_torch.serve.service import ServiceConfig
    cfg = ServiceConfig(ae_config="unused", pc_config="unused",
                        max_queue=8,
                        priority_classes=default_priority_classes(8))
    kw.setdefault("poll_every_s", 5.0)
    return FrontDoorRouter(cfg, replicas=replicas,
                           launcher=fakes.launcher, **kw)


# -- add_replica: warm-before-admit + digest refusal --------------------------

def test_add_replica_admits_into_the_rotation():
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=1).start()
    try:
        assert r.encode("a", timeout=5)[1] == 0
        info = r.add_replica()
        assert info["replica"] == 1
        got = {r.encode(f"i{k}", timeout=5)[1] for k in range(4)}
        assert got == {0, 1}                  # round-robins over both
        assert r.metrics.counter("serve_router_scale_ups").value == 1
        assert r.metrics.gauge("serve_router_replicas").value == 2
        assert r.health()["replicas"] == {"0": "live", "1": "live"}
    finally:
        r.drain(timeout_s=5)


def test_add_replica_digest_mismatch_refused_before_any_traffic():
    fakes = _ElasticFakes()
    fakes.digest_for[1] = "WRONG"
    r = _router(fakes, replicas=1).start()
    try:
        with pytest.raises(FleetScaleError, match="WRONG"):
            r.add_replica()
        # the refused newcomer never joined: no slot, no traffic
        assert r.health()["replicas"] == {"0": "live"}
        assert not fakes.received.get(1)
        assert r.metrics.counter("serve_router_digest_skew").value == 1
        assert r.metrics.counter("serve_router_scale_ups").value == 0
        assert r.encode("still", timeout=5)[1] == 0
    finally:
        r.drain(timeout_s=5)


def test_add_replica_warm_before_admit_takes_no_traffic_until_ready():
    """The warm-before-admit pin: while the newcomer is still warming
    (ready handshake not answered), every request routes to the
    existing rotation — and the router process itself builds nothing
    natively across the whole admit (the JAX test's compile budget 0)."""
    fakes = _ElasticFakes()
    gate = threading.Event()
    fakes.delay_ready[1] = gate
    r = _router(fakes, replicas=1).start()
    try:
        out = {}
        builds = native_build.build_count()
        t = threading.Thread(
            target=lambda: out.update(info=r.add_replica()))
        t.start()
        # the newcomer exists but is NOT routable: traffic stays on 0
        for k in range(4):
            assert r.encode(f"w{k}", timeout=5)[1] == 0
        assert not fakes.received.get(1)
        gate.set()                       # warmup finishes -> admit
        t.join(10)
        assert not t.is_alive() and out["info"]["replica"] == 1
        got = {r.encode(f"a{k}", timeout=5)[1] for k in range(4)}
        assert got == {0, 1}
        assert native_build.build_count() == builds
    finally:
        r.drain(timeout_s=5)


def test_concurrent_scale_ops_and_swaps_mutually_refused():
    from dsin_tpu_torch.serve.router import FleetSwapError
    fakes = _ElasticFakes()
    gate = threading.Event()
    fakes.delay_ready[1] = gate
    r = _router(fakes, replicas=1).start()
    try:
        t = threading.Thread(target=lambda: r.add_replica())
        t.start()
        deadline = time.monotonic() + 5
        while not r._scaling:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        with pytest.raises(FleetScaleError, match="already in flight"):
            r.add_replica()
        with pytest.raises(FleetScaleError, match="already in flight"):
            r.drain_replica()
        with pytest.raises(FleetSwapError, match="scale op"):
            r.swap_model("/ckpt/x")
        gate.set()
        t.join(10)
        # and the inverse: a swap in flight refuses scale ops
        with r._lock:
            r._swapping = True
        try:
            with pytest.raises(FleetScaleError, match="swap"):
                r.add_replica()
        finally:
            with r._lock:
                r._swapping = False
    finally:
        r.drain(timeout_s=5)


# -- drain_replica ------------------------------------------------------------

def test_drain_replica_graceful_with_inflight_resolves_exactly_once():
    """The victim's parked in-flight request survives the drain: it
    leaves through the shared leave-rotation path and re-dispatches to
    the survivor — resolved exactly once, never hung."""
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=2).start()
    try:
        fakes.respond[0] = False
        fut = r.submit_encode("img")              # rr -> replica 0
        assert fakes.got_request[0].wait(2)
        out = r.drain_replica(idx=0, timeout_s=0.3)
        assert out["replica"] == 0
        assert fut.result(timeout=5)[1] == 1      # survivor answered
        assert r.health()["replicas"]["0"] == "drained"
        assert r.metrics.counter("serve_router_scale_downs").value == 1
        # a graceful exit is NOT a death
        assert r.metrics.counter(
            "serve_router_replica_deaths").value == 0
        assert r.metrics.counter("serve_router_reroutes").value == 1
        # all new traffic lands on the survivor
        assert all(r.encode(f"p{k}", timeout=5)[1] == 1
                   for k in range(3))
    finally:
        r.drain(timeout_s=5)


def test_drain_refuses_the_last_live_replica():
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=1).start()
    try:
        with pytest.raises(FleetScaleError, match="last live"):
            r.drain_replica()
        assert r.encode("x", timeout=5)[1] == 0
    finally:
        r.drain(timeout_s=5)


def test_drain_victim_autopick_prefers_fewest_pins():
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=2).start()
    try:
        sid = r.open_session("side")              # rr pins onto 0
        with r._lock:
            pinned_to = r._sessions[sid]
        out = r.drain_replica()                   # auto-pick
        assert out["replica"] != pinned_to        # pinless one drained
        # the pinned session survives an UNRELATED drain
        assert r.metrics.counter(
            "serve_router_session_orphans").value == 0
    finally:
        r.drain(timeout_s=5)


def test_pins_across_drain_regression():
    """Regression: draining a replica orphans its
    session pins EXACTLY like a death — same counter, same typed
    SessionExpired at the door, both during and after the drain."""
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=2).start()
    try:
        sid = r.open_session("side")
        with r._lock:
            pinned_to = r._sessions[sid]
        assert r.metrics.gauge(
            "serve_router_sessions_pinned").value == 1
        out = r.drain_replica(idx=pinned_to, timeout_s=2.0)
        assert out["replica"] == pinned_to
        assert r.metrics.counter(
            "serve_router_session_orphans").value == 1
        assert r.metrics.gauge(
            "serve_router_sessions_pinned").value == 0
        with pytest.raises(SessionExpired):
            r.submit_decode_si(b"blob", sid)
        # identical to what a DEATH of the pinned replica produces:
        fakes2 = _ElasticFakes()
        r2 = _router(fakes2, replicas=2).start()
        try:
            sid2 = r2.open_session("side")
            with r2._lock:
                pinned2 = r2._sessions[sid2]
            fakes2.kill(pinned2)
            deadline = time.monotonic() + 5
            while r2.metrics.counter(
                    "serve_router_session_orphans").value == 0:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            assert r2.metrics.counter(
                "serve_router_session_orphans").value == 1
            with pytest.raises(SessionExpired):
                r2.submit_decode_si(b"blob", sid2)
        finally:
            r2.drain(timeout_s=5)
    finally:
        r.drain(timeout_s=5)


def test_draining_replica_does_not_degrade_health():
    """A routine scale-down must not page anyone: 'draining' is a
    purposeful exit, not degradation — /healthz stays ok."""
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=2).start()
    try:
        with r._lock:
            r._state[1] = "draining"
        try:
            assert r.health()["status"] == "ok"
        finally:
            with r._lock:
                r._state[1] = "live"
    finally:
        r.drain(timeout_s=5)


def test_pinned_submit_during_drain_window_is_typed_at_the_door():
    """State 'draining' (before the replica is gone) must already
    answer pinned SI submits typed: the victim left the rotation the
    moment the drain was decided."""
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=2).start()
    try:
        sid = r.open_session("side")
        with r._lock:
            pinned_to = r._sessions[sid]
            r._state[pinned_to] = "draining"      # the drain window
        try:
            with pytest.raises(SessionExpired):
                r.submit_decode_si(b"blob", sid)
        finally:
            with r._lock:
                r._state[pinned_to] = "live"
    finally:
        r.drain(timeout_s=5)


# -- conditional fleet rollback (the fleet-health driver's mode) --------------

def test_conditional_rollback_skips_already_converged_replicas():
    """A replica whose own watchdog already rolled back refuses the
    conditional rollback typed — reported skipped, never failed: the
    fleet driver converges with the per-replica watchdog."""
    fakes = _ElasticFakes(digest="bad")
    r = _router(fakes, replicas=2).start()
    try:
        fakes.prev = {0: "good", 1: "good"}
        fakes.serving[1] = "good"      # replica 1 already rolled back
        out = r.rollback(expect_digest="bad")
        assert out["digest"] == "good"
        assert out["replicas"] == [0]
        assert out["skipped"] == [1]
        assert fakes.serving == {0: "good", 1: "good"}
        assert r.params_digest == "good"
        assert r.metrics.counter("serve_router_rollbacks").value == 1
    finally:
        r.drain(timeout_s=5)


def test_conditional_rollback_all_skipped_is_not_an_error():
    """Every replica already rolled itself back: the conditional
    rollback reports an all-skipped convergence, never a failure."""
    fakes = _ElasticFakes(digest="bad")
    r = _router(fakes, replicas=2).start()
    try:
        fakes.serving = {0: "good", 1: "good"}
        out = r.rollback(expect_digest="bad")
        assert out["replicas"] == [] and out["skipped"] == [0, 1]
        assert fakes.serving == {0: "good", 1: "good"}
        # the router cannot learn the converged digest here (fakes
        # expose no /healthz): it must record UNKNOWN, never keep the
        # sick name — a stale sick digest would refuse every healthy
        # scale-up newcomer forever
        assert out["digest"] is None and r.params_digest is None
        # ... and an unknown digest ADMITS a newcomer (re-learning the
        # fleet digest from its handshake) instead of wedging scale-up
        fakes.digest_for[2] = "good"
        r.add_replica()
        assert r.params_digest == "good"
    finally:
        r.drain(timeout_s=5)


def test_conditional_rollback_no_prev_is_a_failure_not_a_skip():
    """A replica SERVING the sick digest with nothing to roll back to
    cannot converge — that is a fleet split the operator must see,
    never a silent 'skipped'."""
    from dsin_tpu_torch.serve.router import FleetSwapError
    fakes = _ElasticFakes(digest="bad")
    r = _router(fakes, replicas=2).start()
    try:
        fakes.prev = {0: "good", 1: None}    # 1 cold-built the sick model
        with pytest.raises(FleetSwapError, match="1 failure"):
            r.rollback(expect_digest="bad")
    finally:
        r.drain(timeout_s=5)


def test_rollback_and_scale_ops_mutually_refused():
    """A rollback is a fleet digest transition: a scale op racing it
    could admit a newcomer validated against the pre-rollback digest."""
    from dsin_tpu_torch.serve.router import FleetSwapError
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=2).start()
    try:
        with r._lock:
            r._scaling = True
        try:
            with pytest.raises(FleetSwapError, match="scale op"):
                r.rollback()
        finally:
            with r._lock:
                r._scaling = False
        with r._lock:
            r._swapping = True
        try:
            with pytest.raises(FleetSwapError, match="already in"):
                r.rollback()
        finally:
            with r._lock:
                r._swapping = False
    finally:
        r.drain(timeout_s=5)


def test_admission_caps_rescale_with_the_live_fleet():
    """Derived admission limits track fleet size: scaled-up capacity
    behind the old aggregate cap would shed exactly the load the
    scale-up was fired to absorb."""
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=1).start()
    try:
        base = dict(r.admission.limits)
        r.add_replica()
        assert r.admission.limits == {c: 2 * v for c, v in base.items()}
        r.drain_replica()
        assert r.admission.limits == base
    finally:
        r.drain(timeout_s=5)


def test_explicit_admission_limits_never_rescale():
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=1,
                admission_limits={"interactive": 5, "bulk": 5}).start()
    try:
        r.add_replica()
        assert r.admission.limits == {"interactive": 5, "bulk": 5}
    finally:
        r.drain(timeout_s=5)


def test_unconditional_rollback_still_raises_on_divergence():
    from dsin_tpu_torch.serve.router import FleetSwapError
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=2).start()
    try:
        fakes.prev = {0: "pa", 1: "pb"}           # diverging rollbacks
        with pytest.raises(FleetSwapError, match="did not converge"):
            r.rollback()
    finally:
        r.drain(timeout_s=5)


# -- the Autoscaler control loop on synthetic snapshots -----------------------

def _occ_snapshot(router, outstanding, canary_failing=()):
    states = {str(k): v for k, v in
              ((rep.idx, router._state.get(rep.idx))
               for rep in router._all_replicas())}
    live = [i for i, s in states.items() if s == "live"]
    occ = {i: {"state": states[i],
               "outstanding": (outstanding if i in live else 0),
               "queue_depth": 0.0, "batch_occupancy_mean": None}
           for i in states}
    canary = {i: {"status": ("failed" if int(i) in canary_failing
                             else "passed"), "digest": "x"}
              for i in live}
    return {
        "info": {"replica_states": states, "replica_occupancy": occ,
                 "replicas_stale": [],
                 "quality": {
                     "canary": canary,
                     "replicas_canary_failing": sorted(canary_failing),
                     "fleet_canary_ok": not canary_failing,
                     "replica_errors": {}}},
        "counters": {}, "histograms": {},
    }


def test_autoscaler_tick_scales_up_then_drains_down():
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=1).start()
    state = {"outstanding": 50}
    scaler = Autoscaler(
        r, AutoscaleConfig(min_replicas=1, max_replicas=2,
                           hysteresis_checks=1, idle_checks=1,
                           up_cooldown_s=0.0, down_cooldown_s=0.0,
                           outstanding_high=8.0, outstanding_low=1.0),
        snapshot_fn=lambda: _occ_snapshot(r, state["outstanding"]))
    try:
        out = scaler.tick(now=0.0)
        assert out["action"] == {"up": 1}
        assert r.health()["live"] == 2
        assert r.metrics.counter("serve_autoscale_ups").value == 1
        state["outstanding"] = 0
        out = scaler.tick(now=100.0)
        assert out["action"] == {"down": 1}      # newest drains first
        assert r.health()["live"] == 1
        assert r.metrics.counter("serve_autoscale_downs").value == 1
    finally:
        r.drain(timeout_s=5)


def test_autoscaler_drives_conditional_fleet_rollback_on_canary():
    fakes = _ElasticFakes(digest="bad")
    r = _router(fakes, replicas=2).start()
    fakes.prev = {0: "good", 1: "good"}
    state = {"failing": (0, 1)}
    scaler = Autoscaler(
        r, AutoscaleConfig(hysteresis_checks=1, up_cooldown_s=0.0),
        health_policy=FleetHealthPolicy(hysteresis_checks=1,
                                        cooldown_s=0.0),
        snapshot_fn=lambda: _occ_snapshot(
            r, 0, canary_failing=state["failing"]))
    try:
        out = scaler.tick(now=0.0)
        assert out["rollback"]["reason"] == "canary"
        assert out["rollback"]["rolled_back_from"] == "bad"
        assert out["rollback"]["digest"] == "good"
        assert r.params_digest == "good"
        assert fakes.serving == {0: "good", 1: "good"}
        assert r.metrics.counter(
            "serve_autoscale_fleet_rollbacks").value == 1
        # the canaries recover on the good model: no second fire
        state["failing"] = ()
        out = scaler.tick(now=100.0)
        assert out["rollback"] is None
    finally:
        r.drain(timeout_s=5)


def test_autoscaler_refuses_fleet_rollback_while_digest_unknown():
    """With the fleet digest unknown, a fired health verdict must NOT
    become an UNCONDITIONAL rollback (it would ping-pong converged
    replicas back onto their prev — possibly sick — bundle)."""
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=2).start()
    scaler = Autoscaler(
        r, AutoscaleConfig(hysteresis_checks=1, up_cooldown_s=0.0),
        health_policy=FleetHealthPolicy(hysteresis_checks=1,
                                        cooldown_s=0.0),
        snapshot_fn=lambda: _occ_snapshot(r, 0, canary_failing=(0, 1)))
    try:
        r.params_digest = None                # the unknown window
        out = scaler.tick(now=0.0)
        assert out["rollback"]["error"] == "fleet digest unknown"
        assert fakes.serving == {0: "d0", 1: "d0"}   # nobody flipped
        assert r.metrics.counter("serve_autoscale_errors").value == 1
        assert r.metrics.counter(
            "serve_autoscale_fleet_rollbacks").value == 0
    finally:
        r.drain(timeout_s=5)


def test_crash_during_drain_grace_window_counts_as_death():
    """EOF while merely 'draining' (stop not yet sent) is a real crash:
    it must hit the death counter and flight dump, not read as a
    routine scale-down; EOF after 'stopping' stays a graceful drain."""
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=2).start()
    try:
        with r._lock:
            r._state[1] = "draining"          # the grace window
        fakes.kill(1)
        deadline = time.monotonic() + 5
        while r.health()["replicas"]["1"] != "dead":
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert r.metrics.counter(
            "serve_router_replica_deaths").value == 1
        # the graceful direction: told to stop -> EOF is a drain
        fakes2 = _ElasticFakes()
        r2 = _router(fakes2, replicas=2).start()
        try:
            with r2._lock:
                r2._state[1] = "stopping"
            fakes2.kill(1)
            deadline = time.monotonic() + 5
            while r2.health()["replicas"]["1"] != "drained":
                assert time.monotonic() < deadline
                time.sleep(0.01)
            assert r2.metrics.counter(
                "serve_router_replica_deaths").value == 0
        finally:
            r2.drain(timeout_s=5)
    finally:
        r.drain(timeout_s=5)


def test_autoscaler_loop_survives_a_throwing_snapshot():
    fakes = _ElasticFakes()
    r = _router(fakes, replicas=1).start()

    def _boom():
        raise RuntimeError("scrape exploded")

    scaler = Autoscaler(r, AutoscaleConfig(check_every_s=0.01),
                        snapshot_fn=_boom)
    try:
        scaler.start()
        deadline = time.monotonic() + 5
        while r.metrics.counter("serve_autoscale_errors").value < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert scaler._thread.is_alive()
    finally:
        scaler.stop()
        r.drain(timeout_s=5)


def test_autoscaler_scale_refusal_is_counted_not_fatal():
    """add_replica failing (here: a digest-mismatching newcomer) must
    land in serve_autoscale_errors and the flight ring, not kill the
    loop or the fleet."""
    fakes = _ElasticFakes()
    fakes.digest_for[1] = "WRONG"
    r = _router(fakes, replicas=1).start()
    scaler = Autoscaler(
        r, AutoscaleConfig(hysteresis_checks=1, up_cooldown_s=0.0,
                           outstanding_high=8.0),
        snapshot_fn=lambda: _occ_snapshot(r, 50))
    try:
        out = scaler.tick(now=0.0)
        assert out["action"]["up"] is None
        assert "WRONG" in out["action"]["error"]
        assert r.metrics.counter("serve_autoscale_errors").value == 1
        assert r.health()["live"] == 1
        assert r.encode("ok", timeout=5)[1] == 0
    finally:
        r.drain(timeout_s=5)
