"""Model-health telemetry of the port's service (`serve/quality.py`) against
the JAX package's, on the CPU.

The host-side rules are the JAX package's own, so they are held against it
exactly: `canary_inputs` bit for bit (goldens are keyed by those arrays),
`validate_goldens` / `compare_goldens` / `wave_canary_verdict` on one table
of cases, the watchdog's verdicts and the SI-match alarm's transitions on
one scripted sequence. Then the port's service at the tiny configuration
(tests/test_train_step.py, buckets (16, 24) and (32, 48), SI on): the bpp,
coding-gap and SI-score exports, the canary (serve path equal to the
bundle probe, self-anchoring, the catch matrix, a failure arming the
watchdog), the manifest's canary validation, no native build with every
signal on, and the service's SI-score decision (scores never push the
search off K2 on the card). All exact.
"""

import numpy as np
import pytest

from dsin_tpu.serve import quality as jax_quality
from dsin_tpu.serve.metrics import MetricsRegistry as JaxMetrics
from dsin_tpu.serve.swap import RollbackWatchdog as JaxWatchdog
from dsin_tpu.serve.trace import FlightRecorder as JaxFlight
from dsin_tpu_torch import native_build
from dsin_tpu_torch.config import Config
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.serve import (CompressionService, MetricsRegistry,
                                  QualityMonitor, RollbackWatchdog,
                                  ServiceConfig)
from dsin_tpu_torch.serve import quality as quality_lib
from dsin_tpu_torch.serve.trace import FlightRecorder
from dsin_tpu_torch.train import checkpoint as ckpt_lib
from test_train_step import tiny_ae_cfg, tiny_pc_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BUCKETS = ((16, 24), (32, 48))


@pytest.fixture(scope="module")
def cfg_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("quality_cfg")
    ae_p, pc_p = str(d / "ae"), str(d / "pc")
    with open(ae_p, "w") as f:
        f.write(str(tiny_ae_cfg(crop_size=(16, 24), batch_size=1)))
    with open(pc_p, "w") as f:
        f.write(str(tiny_pc_cfg()))
    return ae_p, pc_p


@pytest.fixture(scope="module")
def service(cfg_files):
    ae_p, pc_p = cfg_files
    svc = CompressionService(ServiceConfig(
        ae_config=ae_p, pc_config=pc_p, buckets=BUCKETS, max_batch=2,
        max_wait_ms=2.0, max_queue=16, workers=1, entropy_workers=1,
        enable_si=True, session_max=4, rollback_watchdog_window_s=60.0,
        device="cpu")).start()
    svc.warmup()
    yield svc
    assert svc.drain()


def _img(rng, h, w):
    return rng.integers(0, 255, (h, w, 3), dtype=np.uint8)


# -- the host-side rules against the JAX package's ----------------------------

@pytest.mark.parametrize("buckets,seed", [
    (((16, 24), (32, 48)), 0), (((160, 600), (320, 1224)), 0),
    (((16, 24),), 7)])
def test_canary_inputs_bit_equal_to_jax(buckets, seed):
    got = quality_lib.canary_inputs(buckets, seed)
    want = jax_quality.canary_inputs(buckets, seed)
    assert list(got) == list(want)
    for key in want:
        for a, b in zip(got[key], want[key]):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


def _golden_cases():
    dig = {"16x24": {"encode": "a" * 16, "decode": "b" * 16,
                     "decode_si": "c" * 16},
           "32x48": {"encode": "d" * 16, "decode": "e" * 16,
                     "decode_si": None}}
    good = quality_lib.goldens_struct(0, BUCKETS, dig)
    observed = {k: dict(v) for k, v in dig.items()}
    flipped = {k: dict(v) for k, v in dig.items()}
    flipped["16x24"]["decode_si"] = "f" * 16
    return [
        (good, observed, 0, BUCKETS), (good, observed, 1, BUCKETS),
        (good, observed, 0, [(64, 96)]), (good, flipped, 0, BUCKETS),
        ({"bogus": 1}, observed, 0, BUCKETS), ("nope", observed, 0, BUCKETS),
        ({**good, "buckets": []}, observed, 0, BUCKETS),
        ({**good, "digests": {"16x24": {"encode": "x"}}}, observed, 0,
         BUCKETS),
        (good, {"16x24": {"encode": "a" * 16, "decode": None}}, 0,
         BUCKETS[:1])]


@pytest.mark.parametrize("case", range(9))
def test_golden_rules_equal_jax(case):
    goldens, observed, seed, buckets = _golden_cases()[case]
    assert quality_lib.validate_goldens(goldens) == \
        jax_quality.validate_goldens(goldens)
    assert quality_lib.compare_goldens(goldens, observed, seed=seed,
                                       buckets=buckets) == \
        jax_quality.compare_goldens(goldens, observed, seed=seed,
                                    buckets=buckets)


def test_wave_canary_verdict_equal_jax():
    d = "abc"
    table = [None, {}, {"canary": {}},
             {"canary": {0: {"digest": d, "status": "ok"}}},
             {"canary": {0: {"digest": d, "status": "ok"},
                         1: {"digest": "old", "status": "ok"}}},
             {"canary": {0: {"digest": d, "status": "failed"}}},
             {"canary": {0: {"digest": d, "status": "error"},
                         1: {"digest": d, "status": "ok"}}},
             {"canary": {0: {"digest": d, "status": "busy"}}},
             {"canary": {0: "junk", 1: {"digest": d, "status": "ok"}}}]
    got = [quality_lib.wave_canary_verdict(q, d) for q in table]
    assert got == [jax_quality.wave_canary_verdict(q, d) for q in table]
    assert got[3] is True and got[5] is False and got[0] is None


def test_watchdog_verdicts_equal_jax():
    """One scripted sequence of samples, arms, canary failures and
    evaluations through both watchdogs: every return value equal."""
    script = [("sample", 0.0, 0, 0), ("sample", 1.0, 1, 10),
              ("arm", 2.0, "b", 1, 10), ("evaluate", 2.5, 1, 12),
              ("evaluate", 13.0, 1, 12), ("evaluate", 13.0, 9, 20),
              ("evaluate", 14.0, 9, 20), ("canary", "b"), ("canary", "x"),
              ("evaluate", 14.5, 9, 21), ("arm", 20.0, "c", 9, 21),
              ("sample", 25.0, 9, 30), ("evaluate", 31.0, 9, 40),
              ("canary", "c"), ("evaluate", 31.5, 9, 40),
              ("arm", 40.0, "d", 9, 40), ("disarm",), ("canary", "d"),
              ("evaluate", 60.0, 30, 60)]
    outs = []
    for wd in (RollbackWatchdog(10.0, 0.3, 4), JaxWatchdog(10.0, 0.3, 4)):
        out = []
        for op, *a in script:
            if op == "sample":
                out.append(wd.sample(*a))
            elif op == "arm":
                out.append(wd.arm(*a))
            elif op == "evaluate":
                out.append(wd.evaluate(*a))
            elif op == "canary":
                out.append(wd.note_canary_failure(*a))
            else:
                out.append(wd.disarm())
            out.append(wd.armed)
        outs.append(out)
    assert outs[0] == outs[1]
    fired = [v for v in outs[0] if isinstance(v, dict) and v["fire"]]
    assert [v["reason"] for v in fired] == ["error_rate", "canary", "canary"]


def test_si_alarm_transitions_equal_jax():
    """The same score sequence through both monitors: summaries, the alarm
    counters and gauge, and the flight events' states equal after every
    step (the JAX test's script, then a session past the decay window)."""
    rng = np.random.default_rng(3)
    script = [("open", "good"), ("open", "bad"),
              ("scores", "phantom", np.full(4, 0.1)),
              ("scores", "good", np.array([0.9, 0.8, 0.7, 0.95])),
              ("scores", "bad", np.array([0.1, 0.05])),
              ("scores", "bad", np.array([0.2, 0.1])),
              ("scores", "bad", np.full(32, 0.9)),
              ("open", "long")]
    script += [("scores", "long", rng.uniform(0.6, 1.0, 100))
               for _ in range(12)]
    script += [("scores", "long", rng.uniform(0.0, 0.3, 100))
               for _ in range(6)]
    script += [("gone", "bad", "lru"), ("gone", "long", "closed"),
               ("gone", "good", "lru")]
    states = []
    for metrics, flight, qm_cls in (
            (MetricsRegistry(), FlightRecorder(capacity=256), QualityMonitor),
            (JaxMetrics(), JaxFlight(capacity=256),
             jax_quality.QualityMonitor)):
        qm = qm_cls(metrics=metrics, flight=flight, si_score_floor=0.5,
                    si_alarm_frac=0.5, si_alarm_min_samples=4)
        trail = []
        for op, sid, *a in script:
            if op == "open":
                qm.session_open(sid)
            elif op == "scores":
                qm.note_si_scores(sid, a[0])
            else:
                qm.session_gone(sid, a[0])
            trail.append((qm.si_session_summaries(),
                          metrics.counter(
                              "serve_si_match_alarm_transitions").value,
                          metrics.gauge("serve_si_match_alarms").value))
        events = [(e["sid"], e["state"]) for e in flight.snapshot()
                  if e["kind"] == "quality_alarm"]
        states.append((trail, events))
    assert states[0] == states[1]
    assert ("long", "armed") in states[0][1]


def test_gap_head_sampler_is_deterministic_rotation():
    qm = QualityMonitor(metrics=MetricsRegistry(), gap_sample_rate=0.25)
    hits = [qm.sample_gap() for _ in range(16)]
    jqm = jax_quality.QualityMonitor(metrics=JaxMetrics(),
                                     gap_sample_rate=0.25)
    assert hits == [jqm.sample_gap() for _ in range(16)]
    assert sum(hits) == 4
    assert qm.set_gap_sample_rate(1.0) == 0.25
    assert all(qm.sample_gap() for _ in range(5))
    assert qm.set_enabled(False) is True and not qm.sample_gap()
    with pytest.raises(ValueError):
        QualityMonitor(metrics=MetricsRegistry(), gap_sample_rate=1.5)


# -- the service -------------------------------------------------------------

def test_coding_gap_math_vs_hand_coded_stream(service):
    codec = service.codec
    rng = np.random.default_rng(0)
    vol = rng.integers(0, codec.num_centers, (4, 2, 3), dtype=np.int64)
    stream = codec.encode(vol)
    gap = codec.coding_gap(vol, stream)
    want_bits = (len(stream) - 13) * 8
    ideal = codec.ideal_bits(vol, mode="wavefront_np")
    assert gap["payload_bits"] == want_bits
    assert gap["ideal_bits"] == pytest.approx(ideal, abs=1e-3)
    assert gap["gap_bits"] == pytest.approx(want_bits - ideal, abs=1e-3)
    assert gap["gap_bits"] >= 0.0
    with pytest.raises(ValueError, match="not the volume"):
        codec.coding_gap(vol[:2], stream)


def test_service_exports_bpp_gap_and_si_score_metrics(service):
    svc = service
    rng = np.random.default_rng(2)
    prev = svc.quality.set_gap_sample_rate(1.0)
    try:
        res = svc.encode(_img(rng, 16, 24))
        svc.encode(_img(rng, 30, 40))
        sid = svc.open_session(_img(rng, 16, 24))
        svc.decode_si(res.stream, sid)
        svc.decode_si(res.stream, sid)
    finally:
        svc.quality.set_gap_sample_rate(prev)
    snap = svc.metrics.snapshot()
    h = snap["histograms"]
    assert h["serve_bpp_payload_16x24"]["count"] >= 1
    assert h["serve_bpp_wire_16x24"]["mean"] > \
        h["serve_bpp_payload_16x24"]["mean"]
    assert h["serve_bpp_payload_32x48"]["count"] >= 1
    gap = h["serve_coding_gap_pct_16x24"]
    assert gap["count"] >= 1 and gap["min"] >= 0.0
    assert snap["counters"]["serve_coding_gap_samples"] >= 2
    assert h["serve_si_match_score"]["count"] >= 2
    assert sid in svc.quality.si_session_summaries()
    svc.close_session(sid)
    assert sid not in svc.quality.si_session_summaries()


def test_canary_serve_path_matches_bundle_probe_and_self_anchors(service):
    svc = service
    first = svc.run_canary()
    assert first["status"] == "ok" and first["baseline"] == "anchored"
    assert set(first["bucket_ms"]) == {"16x24", "32x48"}
    second = svc.run_canary()
    assert second["status"] == "ok" and second["baseline"] == "self"
    assert svc.metrics.gauge("serve_canary_ok").value == 1
    goldens = svc.canary_goldens()
    assert quality_lib.validate_goldens(goldens) is None
    observed = svc._canary_probe_bundle(svc._swap.current)
    assert goldens["digests"] == observed
    assert svc._canary.baseline_for(svc.model_digest, None,
                                    svc.policy.buckets, observed) == \
        ("self", [])
    key0 = quality_lib.bucket_key(BUCKETS[0])
    partial = quality_lib.goldens_struct(0, [BUCKETS[0]],
                                         {key0: observed[key0]})
    cs = quality_lib.CanaryState(0, svc.metrics)
    assert cs.baseline_for("elsewhere", {"canary": partial},
                           svc.policy.buckets, observed) == ("anchored", [])


def test_canary_catch_matrix(service):
    svc = service
    goldens = svc.canary_goldens()
    observed = svc._canary_probe_bundle(svc._swap.current)
    for bucket in BUCKETS:
        key = quality_lib.bucket_key(bucket)
        for op in ("encode", "decode", "decode_si"):
            assert goldens["digests"][key][op], (key, op)
            bad = {k: dict(v) for k, v in goldens["digests"].items()}
            bad[key][op] = "0" * 16
            mismatches = quality_lib.compare_goldens(
                quality_lib.goldens_struct(0, BUCKETS, bad), observed,
                seed=0, buckets=BUCKETS)
            assert len(mismatches) == 1 and op in mismatches[0]
    assert quality_lib.compare_goldens(goldens, observed, seed=0,
                                       buckets=BUCKETS) == []
    assert quality_lib.compare_goldens(goldens, observed, seed=1,
                                       buckets=BUCKETS)


def test_canary_failure_end_to_end_flight_and_watchdog(service):
    svc = service
    goldens = svc.canary_goldens()
    bad = {k: dict(v) for k, v in goldens["digests"].items()}
    bad[quality_lib.bucket_key(BUCKETS[0])]["encode"] = "f" * 16
    tampered = quality_lib.goldens_struct(goldens["seed"], BUCKETS, bad)
    bundle = svc._swap.current
    old_manifest, old_state = bundle.manifest, svc._canary
    svc._canary = quality_lib.CanaryState(0, svc.metrics, flight=svc.flight)
    bundle.manifest = {"canary": tampered}
    errors, resolved = svc._error_counters()
    svc._watchdog.arm(0.0, svc.model_digest, errors, resolved)
    try:
        fails = svc.metrics.counter("serve_canary_failures").value
        result = svc.run_canary()
        assert result["status"] == "failed"
        assert result["baseline"] == "manifest"
        assert any("encode" in m for m in result["mismatches"])
        assert svc.metrics.counter("serve_canary_failures").value == \
            fails + 1
        assert svc.metrics.gauge("serve_canary_ok").value == 0
        events = [e for e in svc.flight.snapshot()
                  if e["kind"] == "canary_failure"]
        assert events and events[-1]["digest"] == svc.model_digest
        verdict = svc._watchdog.evaluate(0.1, *svc._error_counters())
        assert verdict["fire"] is True and verdict["reason"] == "canary"
        assert verdict["digest"] == svc.model_digest
        assert svc.health()["quality"]["canary"]["status"] == "failed"
    finally:
        bundle.manifest = old_manifest
        svc._canary = old_state
        svc._watchdog.disarm()
    assert svc.run_canary()["status"] == "ok"


def test_no_native_build_with_quality_telemetry_on(service):
    svc = service
    rng = np.random.default_rng(9)
    before = native_build.build_count()
    prev = svc.quality.set_gap_sample_rate(1.0)
    try:
        res = svc.encode(_img(rng, 16, 24))
        svc.decode(res.stream)
        sid = svc.open_session(_img(rng, 16, 24))
        svc.decode_si(res.stream, sid)
        svc.close_session(sid)
        assert svc.run_canary()["status"] == "ok"
    finally:
        svc.quality.set_gap_sample_rate(prev)
    assert native_build.build_count() == before
    assert svc.metrics.gauge("serve_native_builds").value == before


def test_build_manifest_validates_canary(service):
    state = ckpt_lib.state_from_model(service.server.model)
    with pytest.raises(ValueError, match="canary"):
        ckpt_lib.build_manifest(state, extra={"canary": {"bogus": 1}})
    goldens = service.canary_goldens()
    assert ckpt_lib.build_manifest(
        state, extra={"canary": goldens})["canary"] == goldens


@pytest.mark.parametrize("device_type,quality,l2,impl,want", [
    ("cuda", True, False, "auto", ("kernel", False)),
    ("cuda", False, False, "auto", ("kernel", False)),
    ("cuda", True, False, "tiled", ("tiled", True)),
    ("cuda", True, True, "auto", ("torch", False)),
    ("cpu", True, False, "auto", ("torch", True)),
    ("cpu", False, False, "auto", ("torch", False))])
def test_si_scores_never_push_the_search_off_k2(device_type, quality, l2,
                                                impl, want):
    """The service's SI-score decision: on the card under 'auto' the route
    is the kernel with scores off, whatever quality says (asking for them
    would route every SI batch to the plain search); scores are on only
    where the route returns them and the search is Pearson."""
    cfg = Config({"use_L2andLAB": l2, "use_gauss_mask": True,
                  "sifinder_impl": impl})
    assert sifinder_lib.service_si_scores(cfg, device_type, quality) == want


def test_quality_knobs_are_validated_typed():
    """The monitor's and the watchdog's constructors refuse bad knobs, as
    the JAX package's do."""
    for kw in ({"gap_sample_rate": -0.1}, {"si_alarm_frac": 0.0},
               {"si_alarm_min_samples": 0}):
        with pytest.raises(ValueError):
            QualityMonitor(metrics=MetricsRegistry(), **kw)
    for args in ((0.0, 0.5, 8), (1.0, 0.0, 8), (1.0, 0.5, 0)):
        with pytest.raises(ValueError):
            RollbackWatchdog(*args)


def test_serve_bench_quality_leg_json_contract(cfg_files, tmp_path):
    """The bench's --quality leg at the tiny configuration: exit 0, the
    JSON contract, every per-bucket gap and bpp histogram and the SI-match
    scores populated, a green canary, no native build. The on/off overhead
    is recorded, not gated (a wall-clock gate fails on a shared host)."""
    import json

    from dsin_tpu_torch.tools import serve_bench
    out = str(tmp_path / "q.json")
    rc = serve_bench.main([
        "--quality", "--device", "cpu", "--out", out,
        "--ae_config", cfg_files[0], "--pc_config", cfg_files[1],
        "--buckets", "16,24 32,48", "--shapes", "16,24 14,20 32,48",
        "--entropy_workers", "1", "--quality_requests", "6",
        "--quality_repeats", "1"])
    assert rc == 0
    with open(out) as f:
        section = json.load(f)["quality"]
    assert set(section) >= {"gap", "bpp", "si_match", "canary", "runs",
                            "pair_ratios", "overhead", "steady_builds",
                            "si_scores", "si_route", "warmup"}
    assert section["si_scores"] is True and section["si_route"] == "torch"
    assert set(section["gap"]["per_bucket_pct"]) == {"16x24", "32x48"}
    assert all(h["count"] >= 1
               for h in section["gap"]["per_bucket_pct"].values())
    assert all(e["payload"]["count"] >= 1 for e in section["bpp"].values())
    assert section["si_match"]["score"]["count"] >= 1
    assert section["canary"]["runs"] >= 1 and section["canary"]["ok"] == 1
    assert len(section["runs"]["on"]) == len(section["runs"]["off"]) == 1
    assert section["steady_builds"] == 0
    assert serve_bench.gate_quality(section) == []
