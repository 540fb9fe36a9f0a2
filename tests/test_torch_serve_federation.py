"""The port's router of routers (dsin_tpu_torch/serve/federation.py) on
the CPU, against the JAX package's `serve/federation.py`.

Parity, all EXACT (the same rules on the same inputs): `RolloutPlan.validate`
refuses the same plans with the same messages; the hierarchical budget is
the same sum of the live members' budgets as membership changes; the
`FederatedMetrics` merge and its stale veto give the same snapshot on the
same member snapshots (frozen seq, old capture and unreachable members
included); a rollout over duck-typed fake member routers with a scripted
canary gives the same per-wave outcomes, abort fields and counters in both
packages.

Then the scenarios of tests/test_serve_federation.py, mirrored over the
same fakes (promotion, canary failure, canary timeout, soak fire, skipped
members, partition and heal, skew, pins, the door's shedding, trace
stitching, the health driver), and one federation over two member fleets
of one REAL service each (replicas on threads of this process) at the
tiny configuration, whose streams are byte-equal to the JAX service's on
the same weights.
"""

import threading
import time
import types

import numpy as np
import pytest

from dsin_tpu.serve import batcher as jax_batcher
from dsin_tpu.serve import federation as jax_federation
from dsin_tpu_torch.serve import batcher as torch_batcher
from dsin_tpu_torch.serve import federation as torch_federation
from dsin_tpu_torch.serve.autoscale import (FederationHealthDriver,
                                            FleetHealthPolicy,
                                            federation_health_from_snapshot)
from dsin_tpu_torch.serve.batcher import (Future, ServiceUnavailable,
                                          ServiceOverloaded)
from dsin_tpu_torch.serve.federation import (FederatedRouter,
                                             FederationError, Member,
                                             MemberUnreachable,
                                             RolloutAborted, RolloutPlan)
from dsin_tpu_torch.serve.quality import wave_canary_verdict
from dsin_tpu_torch.serve.session import SessionExpired
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FUTURES = {jax_federation: jax_batcher.Future,
           torch_federation: torch_batcher.Future}
PACKAGES = (jax_federation, torch_federation)


class _FakeFleet:
    """Duck-types exactly the FrontDoorRouter surface the federation
    touches — scripted digests, canary verdicts, and health so every
    wave-gate branch is reachable deterministically."""

    def __init__(self, name, digest="d0", limits=None, future_cls=Future):
        self.name = name
        self._future_cls = future_cls
        self.health_timeout_s = 0.5
        self.params_digest = digest
        self.prev_digest = "dprev"
        self._class_names = ["interactive", "bulk"]
        self.admission = types.SimpleNamespace(
            limits=dict(limits or {"interactive": 4, "bulk": 4}))
        self.live = 1
        #: "pass" (default) auto-passes the canary on swap; "fail"
        #: fails it; "never" leaves the old verdicts (gate timeout)
        self.canary_mode = "pass"
        self.canary = {}
        self.fleet_canary_ok = None
        self.replicas_canary_failing = []
        self.replica_errors = {}
        self.swap_exc = None
        self.swaps = []
        self.rollbacks = []
        self.submitted = []
        self.opened = []
        self.seq = 0
        self.freeze_seq = False
        self._sid = 0
        self.aggregate = types.SimpleNamespace(
            snapshot=self._agg_snapshot)
        self.traces = types.SimpleNamespace(
            snapshot=self._traces_snapshot)
        self.trace_spans = []

    # -- telemetry -----------------------------------------------------------

    def health(self):
        return {"status": "ok" if self.live else "unhealthy",
                "live": self.live, "replicas": {}, "outstanding": {},
                "params_digest": self.params_digest}

    def _agg_snapshot(self):
        if not self.freeze_seq:
            self.seq += 1
        return {
            "info": {
                "replica_states": {"0": "live" if self.live else
                                   "dead"},
                "replica_digests": {"0": self.params_digest},
                "replicas_unreachable": [], "replicas_stale": [],
                "quality": {
                    "canary": {k: dict(v)
                               for k, v in self.canary.items()},
                    "replicas_canary_failing":
                        list(self.replicas_canary_failing),
                    "fleet_canary_ok": self.fleet_canary_ok,
                    "replica_errors": {
                        k: dict(v)
                        for k, v in self.replica_errors.items()},
                },
            },
            "counters": {f"served_{self.name}": 1},
            "gauges": {}, "accumulators": {}, "histograms": {},
            "locks": {}, "lock_order_inversions": 0,
            "seq": self.seq, "captured_at": time.time(),
        }

    def _traces_snapshot(self, trace_id=None):
        return {"spans": [s for s in self.trace_spans
                          if trace_id is None
                          or s.get("trace_id") == trace_id]}

    # -- control surface -----------------------------------------------------

    def swap_model(self, ckpt_dir, prepare_timeout_s=600.0,
                   commit_timeout_s=60.0):
        if self.swap_exc is not None:
            raise self.swap_exc
        digest = "dnew"
        self.swaps.append(ckpt_dir)
        self.prev_digest, self.params_digest = (self.params_digest,
                                                digest)
        if self.canary_mode == "pass":
            self.canary = {"0": {"status": "ok", "digest": digest}}
            self.fleet_canary_ok = True
        elif self.canary_mode == "fail":
            self.canary = {"0": {"status": "failed", "digest": digest}}
            self.fleet_canary_ok = False
            self.replicas_canary_failing = ["0"]
        return {"digest": digest, "replicas": [0], "prepare": {}}

    def rollback(self, timeout_s=60.0, expect_digest=None):
        self.rollbacks.append(expect_digest)
        if (expect_digest is not None
                and self.params_digest != expect_digest):
            # the real router's all-skipped conditional rollback is a
            # SUCCESS that rolled nothing (already converged)
            return {"digest": self.params_digest, "replicas": [],
                    "skipped": [0]}
        self.prev_digest, self.params_digest = (self.params_digest,
                                                self.prev_digest)
        return {"digest": self.params_digest, "replicas": [0],
                "skipped": []}

    # -- dataplane -----------------------------------------------------------

    def _resolved(self, value):
        f = self._future_cls()
        f.set_result(value)
        return f

    def submit_encode(self, img, deadline_ms=None, priority=None,
                      trace=None):
        self.submitted.append(("encode", img, priority, trace))
        return self._resolved(("blob", self.name))

    def submit_decode(self, blob, deadline_ms=None, priority=None,
                      trace=None):
        self.submitted.append(("decode", blob, priority, trace))
        return self._resolved(("img", self.name))

    def submit_decode_si(self, blob, session_id, deadline_ms=None,
                         priority=None, trace=None):
        self.submitted.append(("decode_si", session_id, priority,
                               trace))
        return self._resolved(("img_si", self.name, session_id))

    def open_session(self, side_img, timeout=120.0):
        self._sid += 1
        sid = f"{self.name}-s{self._sid}"
        self.opened.append(sid)
        return sid

    def close_session(self, session_id, timeout=30.0):
        return True


def _federation(n=3, poll_every_s=5.0, mod=None, **kw):
    """n fake member fleets under one started federation (the port's, or
    `mod`'s); slow polls by default so only tests that WANT the poll
    loop see it."""
    mod = mod or torch_federation
    fakes = [_FakeFleet(f"m{i}", future_cls=FUTURES[mod])
             for i in range(n)]
    members = [mod.Member(f.name, f, control_timeout_s=5.0)
               for f in fakes]
    fed = mod.FederatedRouter(members, poll_every_s=poll_every_s,
                              health_timeout_s=0.5, **kw).start()
    return fed, fakes


def _wait(pred, timeout=5.0, every=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


# -- wave_canary_verdict: the pure gate -------------------------------------

def test_wave_canary_verdict_table():
    new = "dnew"
    # no verdicts at all: evidence incomplete
    assert wave_canary_verdict(None, new) is None
    assert wave_canary_verdict({"canary": {}}, new) is None
    # verdicts still naming the OLD digest are "not yet", never "pass"
    stale = {"canary": {"0": {"status": "ok", "digest": "dold"}}}
    assert wave_canary_verdict(stale, new) is None
    # one failure against the new digest kills the wave immediately,
    # even with other replicas not yet reporting it
    mixed = {"canary": {"0": {"status": "failed", "digest": new},
                        "1": {"status": "ok", "digest": "dold"}}}
    assert wave_canary_verdict(mixed, new) is False
    # full coverage, all ok: pass
    ok = {"canary": {"0": {"status": "ok", "digest": new},
                     "1": {"status": "ok", "digest": new}}}
    assert wave_canary_verdict(ok, new) is True
    # full coverage but a non-ok transient (busy/skipped): keep polling
    busy = {"canary": {"0": {"status": "ok", "digest": new},
                       "1": {"status": "busy", "digest": new}}}
    assert wave_canary_verdict(busy, new) is None


# -- rollout: happy path ------------------------------------------------------

def test_rollout_promotes_wave_by_wave():
    fed, fakes = _federation()
    try:
        plan = RolloutPlan(ckpt_dir="/ckpt/new",
                           waves=(("m0",), ("m1", "m2")),
                           canary_timeout_s=5.0, poll_s=0.01,
                           distribute=False)
        report = fed.rollout(plan)
        assert report["digest"] == "dnew"
        assert fed.params_digest == "dnew"
        for f in fakes:
            assert f.swaps == ["/ckpt/new"]
        assert report["per_member"] == {"m0": "committed",
                                        "m1": "committed",
                                        "m2": "committed"}
        assert fed.metrics.counter(
            "federation_rollout_promotions").value == 1
    finally:
        fed.drain()


def test_rollout_refuses_concurrent_rollouts():
    fed, fakes = _federation(n=1)
    try:
        gate = threading.Event()
        orig = fakes[0].swap_model

        def slow_swap(*a, **kw):
            gate.wait(5)
            return orig(*a, **kw)

        fakes[0].swap_model = slow_swap
        plan = RolloutPlan(ckpt_dir="/c", waves=(("m0",),),
                           canary_timeout_s=5.0, poll_s=0.01,
                           distribute=False)
        t = threading.Thread(target=lambda: fed.rollout(plan),
                             daemon=True)
        t.start()
        assert _wait(lambda: fed._rolling)
        with pytest.raises(FederationError, match="already in flight"):
            fed.rollout(plan)
        gate.set()
        t.join(timeout=10)
    finally:
        fed.drain()


def test_rollout_plan_validation():
    fed, _ = _federation()
    try:
        with pytest.raises(FederationError, match="non-empty"):
            fed.rollout(RolloutPlan(ckpt_dir="/c", waves=()))
        with pytest.raises(FederationError, match="unknown member"):
            fed.rollout(RolloutPlan(ckpt_dir="/c",
                                    waves=(("nope",),)))
        with pytest.raises(FederationError, match="two waves"):
            fed.rollout(RolloutPlan(ckpt_dir="/c",
                                    waves=(("m0",), ("m0",))))
    finally:
        fed.drain()


# -- rollout: wave-gate failures + auto-rollback ------------------------------

def test_wave_canary_failure_rolls_the_wave_back_typed():
    fed, fakes = _federation()
    try:
        fakes[1].canary_mode = "fail"
        plan = RolloutPlan(ckpt_dir="/c", waves=(("m0",), ("m1", "m2")),
                           canary_timeout_s=5.0, poll_s=0.01,
                           distribute=False)
        with pytest.raises(RolloutAborted) as ei:
            fed.rollout(plan)
        err = ei.value
        assert err.wave == 1 and err.digest == "dnew"
        assert "canary" in err.reason
        # the failing wave's committed members rolled back to d0 ...
        assert fakes[1].params_digest == "d0"
        assert fakes[2].params_digest == "d0"
        # ... the PRIOR wave was kept (default plan policy) ...
        assert fakes[0].params_digest == "dnew"
        assert "kept" in err.per_wave[0]["m0"]
        # ... and the federation never promoted
        assert fed.params_digest != "dnew"
        assert "dnew" in fed._aborted
    finally:
        fed.drain()


def test_wave_failure_rolls_prior_waves_back_when_the_plan_says_so():
    fed, fakes = _federation()
    try:
        fakes[2].canary_mode = "fail"
        plan = RolloutPlan(ckpt_dir="/c", waves=(("m0",), ("m1", "m2")),
                           canary_timeout_s=5.0, poll_s=0.01,
                           rollback_prior_waves=True, distribute=False)
        with pytest.raises(RolloutAborted) as ei:
            fed.rollout(plan)
        for f in fakes:
            assert f.params_digest == "d0"
        assert ei.value.per_wave[0]["m0"].startswith("rolled back")
    finally:
        fed.drain()


def test_wave_canary_timeout_is_a_typed_abort_never_a_silent_pass():
    fed, fakes = _federation(n=1)
    try:
        fakes[0].canary_mode = "never"   # verdicts never cover dnew
        plan = RolloutPlan(ckpt_dir="/c", waves=(("m0",),),
                           canary_timeout_s=0.2, poll_s=0.01,
                           distribute=False)
        with pytest.raises(RolloutAborted, match="timed out"):
            fed.rollout(plan)
        assert fakes[0].params_digest == "d0"    # rolled back
    finally:
        fed.drain()


def test_soak_window_health_fire_aborts_the_wave():
    fed, fakes = _federation(n=1)
    try:
        orig = fakes[0].swap_model

        def swap_then_sicken(*a, **kw):
            res = orig(*a, **kw)
            # canary passes the gate, then the fleet turns unanimously
            # canary-sick during the soak window
            fakes[0].replicas_canary_failing = ["0"]
            fakes[0].canary = {"0": {"status": "failed",
                                     "digest": "dnew"}}
            return res

        # note: wave_canary_verdict sees the gate BEFORE the sickness
        # lands only if the gate read the passing snapshot first; make
        # the gate pass instantly by pre-seeding the passing verdict
        def swap_pass_then_sicken(*a, **kw):
            res = orig(*a, **kw)
            threading.Timer(0.15, lambda: (
                fakes[0].__setattr__("replicas_canary_failing", ["0"]),
                fakes[0].__setattr__("canary", {
                    "0": {"status": "failed", "digest": "dnew"}}),
            )).start()
            return res

        fakes[0].swap_model = swap_pass_then_sicken
        plan = RolloutPlan(ckpt_dir="/c", waves=(("m0",),),
                           canary_timeout_s=2.0, poll_s=0.01,
                           soak_s=3.0, distribute=False)
        with pytest.raises(RolloutAborted, match="soak"):
            fed.rollout(plan)
        assert fakes[0].params_digest == "d0"
    finally:
        fed.drain()


def test_member_already_converged_counts_skipped_not_fought():
    """A member whose own watchdog already rolled itself back refuses
    the conditional rollback — the federation records convergence."""
    fed, fakes = _federation(n=2)
    try:
        orig = fakes[1].swap_model

        def swap_then_self_heal(*a, **kw):
            res = orig(*a, **kw)
            fakes[1].canary_mode = "fail"
            # the member's own driver rolls back before the federation
            fakes[1].rollback()
            fakes[1].canary = {"0": {"status": "failed",
                                     "digest": "dnew"}}
            return res

        fakes[1].swap_model = swap_then_self_heal
        plan = RolloutPlan(ckpt_dir="/c", waves=(("m0", "m1"),),
                           canary_timeout_s=5.0, poll_s=0.01,
                           distribute=False)
        with pytest.raises(RolloutAborted) as ei:
            fed.rollout(plan)
        assert "already converged" in ei.value.per_wave[0]["m1"]
        assert fakes[1].params_digest == "d0"
        # exactly one rollback reached the member during the abort
        # (the conditional refused one) — never a second, unconditional
        # "fight" that would ping-pong it off d0
        assert fakes[1].rollbacks.count("dnew") == 1
        assert fakes[0].params_digest == "d0"
    finally:
        fed.drain()


# -- partition tolerance ------------------------------------------------------

def test_partition_mid_rollout_heals_through_the_aborted_digest():
    """The headline chaos shape, deterministic: a member partitioned
    away mid-rollout is evicted; the wave aborts typed and records the
    digest; the member turns out to have COMMITTED the swap whose ack
    the partition ate; on heal, readmission is refused for skew — but
    because the digest is in the aborted set the federation reconciles
    with ONE conditional rollback and then readmits. Zero torn
    versions at the end."""
    fed, fakes = _federation(poll_every_s=0.02, evict_after=2)
    try:
        fed.member("m1").partition()
        assert _wait(lambda: fed.health()["members"]["m1"]
                     == "evicted")
        plan = RolloutPlan(ckpt_dir="/c", waves=(("m0",), ("m1", "m2")),
                           canary_timeout_s=5.0, poll_s=0.01,
                           rollback_prior_waves=True, distribute=False)
        with pytest.raises(RolloutAborted) as ei:
            fed.rollout(plan)
        assert ei.value.wave == 1
        assert "not live" in ei.value.reason
        assert fakes[0].params_digest == "d0"    # prior wave undone
        assert "dnew" in fed._aborted
        # the partition ate the ack, not the commit: the member is
        # actually serving the aborted digest when it heals
        fakes[1].prev_digest = fakes[1].params_digest
        fakes[1].params_digest = "dnew"
        fed.member("m1").heal()
        assert _wait(lambda: fed.health()["members"]["m1"] == "live")
        assert fakes[1].params_digest == "d0"    # reconciled
        assert fed.metrics.counter(
            "federation_reconciles").value == 1
        # zero torn versions across the federation
        assert {f.params_digest for f in fakes} == {"d0"}
    finally:
        fed.drain()


def test_digest_skew_without_abort_evidence_refuses_readmission():
    fed, fakes = _federation(poll_every_s=0.02, evict_after=2)
    try:
        fed.member("m1").partition()
        assert _wait(lambda: fed.health()["members"]["m1"]
                     == "evicted")
        fakes[1].params_digest = "dmystery"      # operator side-load
        fed.member("m1").heal()
        time.sleep(0.3)
        assert fed.health()["members"]["m1"] == "evicted"
        assert fed.metrics.counter(
            "federation_digest_skew").value >= 1
    finally:
        fed.drain()


def test_member_call_failures_are_counted_per_member():
    fed, _ = _federation()
    try:
        fed.member("m2").partition()
        with pytest.raises(MemberUnreachable):
            fed.member("m2").call("health",
                                  fed.member("m2").router.health)
        assert fed.metrics.counter(
            "federation_member_call_failures_m2").value >= 1
    finally:
        fed.drain()


def test_partitioned_member_is_skipped_on_the_dataplane():
    fed, fakes = _federation()
    try:
        fed.member("m0").partition()
        for _ in range(6):
            assert fed.encode("img", timeout=5.0)[0] == "blob"
        assert fakes[0].submitted == []
        assert len(fakes[1].submitted) + len(fakes[2].submitted) == 6
    finally:
        fed.drain()


def test_all_members_gone_is_typed_unavailable():
    fed, _ = _federation(n=1)
    try:
        fed.member("m0").partition()
        with pytest.raises(ServiceUnavailable):
            fed.submit_encode("img")
        # the shed released the admission slot
        assert all(v == 0
                   for v in fed.admission.outstanding().values())
    finally:
        fed.drain()


# -- host-sticky sessions -----------------------------------------------------

def test_sessions_pin_to_one_member_and_expire_typed_on_its_death():
    fed, fakes = _federation(poll_every_s=0.02, evict_after=2)
    try:
        sid = fed.open_session("side")
        owner = fed._sessions[sid]
        assert fed.decode_si("blob", sid, timeout=5.0)[2] == sid
        idx = int(owner[1:])
        fakes[idx].live = 0              # the member's fleet dies
        assert _wait(lambda: fed.health()["members"][owner]
                     == "evicted")
        with pytest.raises(SessionExpired):
            fed.submit_decode_si("blob", sid)
    finally:
        fed.drain()


def test_unknown_session_is_typed():
    fed, _ = _federation(n=1)
    try:
        with pytest.raises(SessionExpired):
            fed.submit_decode_si("blob", "no-such-sid")
    finally:
        fed.drain()


# -- hierarchical admission ---------------------------------------------------

def test_admission_budget_is_the_sum_of_live_member_budgets():
    fed, fakes = _federation(poll_every_s=0.02, evict_after=2)
    try:
        assert fed.admission.limits == {"interactive": 12, "bulk": 12}
        fakes[0].live = 0
        assert _wait(lambda: fed.admission.limits
                     == {"interactive": 8, "bulk": 8})
        fakes[0].live = 1
        assert _wait(lambda: fed.admission.limits
                     == {"interactive": 12, "bulk": 12})
    finally:
        fed.drain()


def test_explicit_admission_limits_never_rescale():
    fakes = [_FakeFleet("m0"), _FakeFleet("m1")]
    fed = FederatedRouter(
        [Member(f.name, f) for f in fakes],
        admission_limits={"interactive": 2, "bulk": 2},
        poll_every_s=0.02, evict_after=2,
        health_timeout_s=0.5).start()
    try:
        fakes[0].live = 0
        time.sleep(0.2)
        assert fed.admission.limits == {"interactive": 2, "bulk": 2}
    finally:
        fed.drain()


def test_federation_door_sheds_typed_over_budget():
    fakes = [_FakeFleet("m0")]

    class _NeverResolve(_FakeFleet):
        pass

    slow = _FakeFleet("m0")
    slow.submit_encode = lambda *a, **kw: Future()  # never resolves
    fed = FederatedRouter([Member("m0", slow)],
                          admission_limits={"interactive": 1,
                                            "bulk": 1},
                          poll_every_s=5.0).start()
    try:
        fed.submit_encode("a", priority="interactive")
        with pytest.raises(ServiceOverloaded):
            fed.submit_encode("b", priority="interactive")
    finally:
        fed.drain()


# -- federated metrics + staleness -------------------------------------------

def test_federated_snapshot_merges_members_and_vetoes_stale():
    fed, fakes = _federation()
    try:
        snap = fed.aggregate.snapshot()
        info = snap["info"]
        assert info["members_scraped"] == 3
        assert set(info["per_member"]) == {"m0", "m1", "m2"}
        assert snap["counters"]["served_m0"] == 1
        # a frozen member replays the same seq: stale, not merged
        fakes[1].freeze_seq = True
        fed.aggregate.snapshot()                  # records m1's seq
        snap2 = fed.aggregate.snapshot()
        assert "m1" in snap2["info"]["members_stale"]
        assert "m1" not in snap2["info"]["per_member"]
    finally:
        fed.drain()


def test_federated_snapshot_reports_unreachable_members():
    fed, _ = _federation()
    try:
        fed.member("m2").partition()
        snap = fed.aggregate.snapshot()
        assert snap["info"]["members_unreachable"] == ["m2"]
        q = snap["info"]["quality"]
        assert "m2" not in q["canary"]
    finally:
        fed.drain()


# -- trace stitching ----------------------------------------------------------

def test_one_trace_id_stitches_across_both_router_tiers():
    fakes = [_FakeFleet("m0")]
    fed = FederatedRouter([Member("m0", fakes[0])],
                          trace_sample_rate=1.0,
                          poll_every_s=5.0).start()
    try:
        fut = fed.submit_encode("img")
        fut.result(5.0)
        # the minted context rode into the member submit unchanged
        op, _, _, ctx = fakes[0].submitted[0]
        assert op == "encode" and ctx is not None and ctx.sampled
        # the federation recorded its own dispatch span for that id
        spans = fed.tracer.snapshot(trace_id=ctx.trace_id)["spans"]
        assert any(s["name"] == "federation.dispatch" for s in spans)
        # and the merged view stitches member-side spans onto the
        # same timeline
        fakes[0].trace_spans = [{"trace_id": ctx.trace_id,
                                 "name": "router.dispatch",
                                 "ts": time.time(), "dur_ms": 1.0}]
        merged = fed.traces.snapshot(trace_id=ctx.trace_id)
        names = {s["name"] for s in merged["spans"]}
        assert {"federation.dispatch", "router.dispatch"} <= names
    finally:
        fed.drain()


# -- the federation health driver --------------------------------------------

def _fed_snap(states, canary_ok, errors=None):
    return {"info": {
        "member_states": dict(states),
        "quality": {
            "canary": {n: {"fleet_canary_ok": v,
                           "replicas_canary_failing": []}
                       for n, v in canary_ok.items()},
            "members_canary_failing": sorted(
                n for n, v in canary_ok.items() if v is False),
            "federation_canary_ok": None,
            "member_errors": dict(errors or {}),
        }}}


def test_federation_health_signals_restrict_to_live_members():
    snap = _fed_snap({"m0": "live", "m1": "evicted"},
                     {"m0": False, "m1": False})
    sig = federation_health_from_snapshot(snap)
    assert sig.live_replicas == 1
    assert sig.canary_failing == 1 and sig.canary_reporting == 1


def test_health_driver_drives_conditional_federation_rollback():
    fed, fakes = _federation(n=2)
    try:
        for f in fakes:
            f.prev_digest, f.params_digest = "d0", "dsick"
        fed.params_digest = "dsick"
        sick = _fed_snap({"m0": "live", "m1": "live"},
                         {"m0": False, "m1": False})
        drv = FederationHealthDriver(
            fed, policy=FleetHealthPolicy(hysteresis_checks=2,
                                          cooldown_s=0.0),
            snapshot_fn=lambda: sick, clock=lambda: 0.0)
        assert drv.tick(now=0.0)["rollback"] is None   # hysteresis
        out = drv.tick(now=1.0)["rollback"]
        assert out["reason"] == "canary"
        assert out["rolled_back_from"] == "dsick"
        for f in fakes:
            assert f.params_digest == "d0"
            assert f.rollbacks == ["dsick"]
        assert "dsick" in fed._aborted
    finally:
        fed.drain()


def test_health_driver_refuses_rollback_while_digest_unknown():
    fed, fakes = _federation(n=1)
    try:
        fed.params_digest = None
        sick = _fed_snap({"m0": "live"}, {"m0": False})
        drv = FederationHealthDriver(
            fed, policy=FleetHealthPolicy(hysteresis_checks=1,
                                          cooldown_s=0.0),
            snapshot_fn=lambda: sick)
        out = drv.tick(now=0.0)["rollback"]
        assert out["error"] == "federation digest unknown"
        assert fakes[0].rollbacks == []
    finally:
        fed.drain()


# -- construction contracts ---------------------------------------------------

def test_federation_refuses_duplicate_names_and_empty_membership():
    f = _FakeFleet("m0")
    with pytest.raises(FederationError, match="at least one"):
        FederatedRouter([])
    with pytest.raises(FederationError, match="unique"):
        FederatedRouter([Member("a", f), Member("a", _FakeFleet("a"))])


def test_federation_refuses_heterogeneous_priority_classes():
    a = _FakeFleet("a")
    b = _FakeFleet("b", limits={"interactive": 4})
    b._class_names = ["interactive"]
    with pytest.raises(FederationError, match="priority classes"):
        FederatedRouter([Member("a", a), Member("b", b)])


def test_start_learns_the_unanimous_digest():
    fed, _ = _federation()
    try:
        assert fed.params_digest == "d0"
    finally:
        fed.drain()


# -- parity with the JAX package ----------------------------------------------

PLANS = [
    ((), ["m0"]), ((("m0",), ()), ["m0"]), ((("nope",),), ["m0", "m1"]),
    ((("m0",), ("m0",)), ["m0", "m1"]), ((("m0", "m1"), ("m2",)),
                                         ["m0", "m1", "m2"]),
    ((("m1",), ("m2", "m0")), ["m0", "m1", "m2"]),
    ((("m0", "m0"),), ["m0"]), ((("m2",),), ["m0", "m1"])]


@pytest.mark.parametrize("waves,known", PLANS)
def test_rollout_plan_validation_equal_jax(waves, known):
    out = []
    for mod in PACKAGES:
        try:
            mod.RolloutPlan(ckpt_dir="/c", waves=waves).validate(known)
            out.append(None)
        except mod.FederationError as e:
            out.append(str(e))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_budget_derivation_equal_jax(seed):
    """The door's budget from the same member budgets through the same
    membership changes (the state table flipped as the poll loop does)."""
    rng = np.random.default_rng(seed)
    limits = [{"interactive": int(rng.integers(1, 20)),
               "bulk": int(rng.integers(1, 40))} for _ in range(4)]
    steps = [{f"m{i}": str(rng.choice(["live", "evicted"]))
              for i in range(4)} for _ in range(12)]
    logs = []
    for mod in PACKAGES:
        fakes = [_FakeFleet(f"m{i}", limits=limits[i],
                            future_cls=FUTURES[mod]) for i in range(4)]
        fed = mod.FederatedRouter([mod.Member(f.name, f) for f in fakes],
                                  poll_every_s=60.0).start()
        try:
            log = [dict(fed.admission.limits)]
            for states in steps:
                with fed._lock:
                    fed._state.update(states)
                fed._rescale_admission()
                log.append((fed._derive_limits(), dict(fed.admission.limits)))
            logs.append(log)
        finally:
            fed.drain()
    assert logs[0] == logs[1]


def _comparable(snap):
    """A federated snapshot without what only one package carries (the
    JAX registry's lock section) or what a clock stamps."""
    out = {k: v for k, v in snap.items()
           if k not in ("locks", "lock_order_inversions", "seq",
                        "captured_at")}
    return out


def test_federated_metrics_merge_equal_jax(monkeypatch):
    """Three rounds of scrapes over four scripted members: fresh, a
    frozen seq (stale), an old capture (stale) and a partitioned one
    (unreachable); the merged snapshots are equal round by round."""
    rounds = []
    for mod in PACKAGES:
        fakes = [_FakeFleet(f"m{i}", future_cls=FUTURES[mod])
                 for i in range(4)]
        for i, f in enumerate(fakes):
            f.canary = {"0": {"status": "ok" if i != 2 else "failed",
                              "digest": "d0"}}
            f.fleet_canary_ok = i != 2
            f.replicas_canary_failing = ["0"] if i == 2 else []
            f.replica_errors = {"0": {"typed_errors": i,
                                      "resolved": 10 + i}}
        fed = mod.FederatedRouter([mod.Member(f.name, f) for f in fakes],
                                  poll_every_s=60.0,
                                  health_timeout_s=0.5).start()
        try:
            got = [_comparable(fed.aggregate.snapshot())]
            fakes[1].freeze_seq = True
            old = fakes[3]._agg_snapshot

            def aged(old=old):
                snap = old()
                snap["captured_at"] -= 60.0
                return snap

            fakes[3].aggregate = types.SimpleNamespace(snapshot=aged)
            fed.member("m0").partition()
            got.append(_comparable(fed.aggregate.snapshot()))
            got.append(_comparable(fed.aggregate.snapshot()))
            rounds.append(got)
        finally:
            fed.drain()
    assert rounds[0] == rounds[1]
    last = rounds[1][-1]["info"]
    assert last["members_unreachable"] == ["m0"]
    assert last["members_stale"] == ["m1", "m3"]


def _scripted(fakes, case):
    if case == "fail_wave1":
        fakes[1].canary_mode = "fail"
    elif case == "timeout":
        fakes[2].canary_mode = "never"
    elif case == "swap_refused":
        fakes[2].swap_exc = RuntimeError("prepare refused")


@pytest.mark.parametrize("case,prior", [
    ("promote", False), ("fail_wave1", False), ("fail_wave1", True),
    ("timeout", True), ("swap_refused", False)])
def test_rollout_outcomes_equal_jax(case, prior):
    runs = []
    for mod in PACKAGES:
        fed, fakes = _federation(mod=mod)
        try:
            _scripted(fakes, case)
            plan = mod.RolloutPlan(
                ckpt_dir="/c", waves=(("m0",), ("m1", "m2")),
                canary_timeout_s=0.3, poll_s=0.01,
                rollback_prior_waves=prior, distribute=False)
            try:
                res = fed.rollout(plan)
                outcome = ("promoted", res)
            except mod.RolloutAborted as e:
                outcome = ("aborted", e.wave, e.digest, e.reason,
                           e.per_wave)
            counters = {k: v for k, v in
                        fed.metrics.snapshot()["counters"].items()
                        if k.startswith("federation")}
            runs.append((outcome, counters, fed.params_digest,
                         [(f.params_digest, f.rollbacks) for f in fakes]))
        finally:
            fed.drain()
    assert runs[0] == runs[1]
    assert runs[1][0][0] == ("promoted" if case == "promote" else "aborted")


# -- two member fleets of real services, against the JAX service -------------

BUCKET = (16, 24)


@pytest.fixture(scope="module")
def tiny_world(tmp_path_factory):
    import jax.numpy as jnp
    from dsin_tpu.serve import CompressionService as JaxService
    from dsin_tpu.serve import ServiceConfig as JaxConfig
    from dsin_tpu.train import checkpoint as jax_ckpt
    from dsin_tpu.train import optim as jax_optim
    from dsin_tpu.train.step import TrainState
    from dsin_tpu_torch import bridge
    from dsin_tpu_torch.config import parse_config
    from dsin_tpu_torch.data.synthetic import make_stereo_pair
    from dsin_tpu_torch.models.dsin import build_model
    from test_train_step import tiny_ae_cfg, tiny_pc_cfg
    root = tmp_path_factory.mktemp("federation_world")
    ae = tiny_ae_cfg(crop_size=BUCKET, batch_size=1)
    pc = tiny_pc_cfg()
    ae_p, pc_p = str(root / "ae"), str(root / "pc")
    for path, cfg in ((ae_p, ae), (pc_p, pc)):
        with open(path, "w") as f:
            f.write(str(cfg))
    source = build_model(parse_config(str(ae)).replace(AE_only=False),
                         parse_config(str(pc)), device="cpu", seed=5)
    params, stats = bridge.jax_from_state_dict(source.state_dict())
    tx = jax_optim.build_optimizer(params, ae.replace(AE_only=False), pc,
                                   num_training_imgs=4)
    ckpt = str(root / "ckpt")
    jax_ckpt.save_checkpoint(ckpt, TrainState(
        params=params, batch_stats=stats, opt_state=tx.init(params),
        step=jnp.int32(0)), manifest_extra={
            "pc_config_sha256": jax_ckpt.config_sha256(pc), "seed": 5})
    rng = np.random.default_rng(12)
    left, _ = make_stereo_pair(rng, BUCKET[0], BUCKET[1] + 8)
    images = [left[:16, :24], left[:14, :20]]
    common = dict(ae_config=ae_p, pc_config=pc_p, ckpt=ckpt,
                  buckets=(BUCKET,), max_batch=2, max_wait_ms=2.0,
                  max_queue=16, entropy_workers=1)
    jsvc = JaxService(JaxConfig(quality_enabled=False,
                                persistent_cache=False, **common)).start()
    try:
        jsvc.warmup()
        streams = [jsvc.encode(img).stream for img in images]
    finally:
        jsvc.drain()
    return common, images, streams


def test_two_member_fleets_stream_the_jax_bytes(tiny_world):
    """Exact: every federated encode (each image once per member, round
    robin) is byte-equal to the JAX service's stream, and decodes."""
    from dsin_tpu_torch.serve import (ServiceConfig,
                                      default_priority_classes)
    from dsin_tpu_torch.serve.router import FrontDoorRouter
    from dsin_tpu_torch.tools.chaos_bench import ThreadReplicas
    common, images, want = tiny_world

    def make_config():
        return ServiceConfig(device="cpu",
                             priority_classes=default_priority_classes(16),
                             **common)

    routers = []
    try:
        for _ in range(2):
            fleet = ThreadReplicas(make_config)
            routers.append(FrontDoorRouter(
                make_config(), replicas=1, launcher=fleet.launcher,
                poll_every_s=0.5).start())
        fed = FederatedRouter([Member(f"m{i}", r)
                               for i, r in enumerate(routers)],
                              poll_every_s=0.5).start()
        try:
            assert fed.params_digest == routers[0].params_digest
            for img, stream in zip(images, want):
                got = [fed.encode(img, timeout=60.0).stream
                       for _ in range(2)]
                assert got == [stream, stream]
            assert fed.decode(want[1], timeout=60.0).shape == (14, 20, 3)
            counters = fed.metrics.snapshot()["counters"]
            assert counters["federation_routed_m_m0"] >= 2
            assert counters["federation_routed_m_m1"] >= 2
        finally:
            fed.drain()
    finally:
        for r in routers:
            r.drain(timeout_s=30)


def test_rollback_relearns_the_digest_the_members_answered():
    """Fault in the reference: after a promotion the poll loop records
    every member at the new digest; rollback() then re-learns the
    federation's digest from those poll records, so the JAX package
    answers the digest it just rolled away from. The port records each
    member's answer to its rollback and answers the digest the members
    serve. Exact."""
    got = {}
    for mod in PACKAGES:
        fed, fakes = _federation(n=2, poll_every_s=0.02, mod=mod)
        try:
            fed.rollout(mod.RolloutPlan(ckpt_dir="/c", waves=(("m0", "m1"),),
                                        canary_timeout_s=5.0, poll_s=0.01,
                                        distribute=False))
            assert _wait(lambda: set(fed.health()["member_digests"].values())
                         == {"dnew"})
            fed._stop.set()              # no poll between here and the read
            fed._poller.join(timeout=5)
            out = fed.rollback()
            assert {f.params_digest for f in fakes} == {"d0"}
            got[mod] = out["digest"]
        finally:
            fed.drain()
    assert got[jax_federation] == "dnew"
    assert got[torch_federation] == "d0"
