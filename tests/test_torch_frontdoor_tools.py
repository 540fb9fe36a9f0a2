"""The front-door legs of the port's serve bench and the session battery of
its chaos bench, on the CPU at the tiny configuration.

`python -m dsin_tpu_torch.tools.serve_bench --frontdoor_only` runs in
process once (module scope) at the tiny configuration of
tests/test_train_step.py, one (64, 96) bucket: the overload leg (24
encodes at 200/s against a queue of 4) and the replica axis (1 then 2
spawned replicas, children at one torch thread). The JSON contract holds,
the fleet is bit-identical, the gate passes with an SLO of a minute (the
CPU's latency is not the card's), and the gate flags each tampered
section. `chaos_bench --smoke --sessions_only` runs with replicas on
threads and reports no violation. Exact.
"""

import copy
import json
import os

import pytest

from dsin_tpu_torch.tools import chaos_bench, serve_bench
from test_train_step import tiny_ae_cfg, tiny_pc_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def frontdoor(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_frontdoor")
    ae_p, pc_p = str(root / "ae"), str(root / "pc")
    with open(ae_p, "w") as f:
        f.write(str(tiny_ae_cfg(crop_size=(16, 24), batch_size=1)))
    with open(pc_p, "w") as f:
        f.write(str(tiny_pc_cfg()))
    out = root / "bench.json"
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"     # the spawned replicas inherit it
    try:
        rc = serve_bench.main([
            "--frontdoor_only", "--out", str(out), "--device", "cpu",
            "--ae_config", ae_p, "--pc_config", pc_p, "--buckets", "64,96",
            "--shapes", "64,96 60,90", "--frontdoor_requests", "24",
            "--frontdoor_rate", "200", "--frontdoor_queue", "4",
            "--entropy_workers", "1", "--interactive_slo_ms", "60000"])
    finally:
        if before is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = before
    return rc, json.loads(out.read_text())


def test_frontdoor_legs_pass_their_gate(frontdoor):
    rc, report = frontdoor
    assert rc == 0
    violations, _ = serve_bench.gate_frontdoor(report["frontdoor"])
    assert violations == []


def test_frontdoor_json_contract(frontdoor):
    _, report = frontdoor
    ov = report["frontdoor"]["overload"]
    assert ov["sheds_bulk_first"] is True and ov["steady_builds"] == 0
    per = ov["per_class"]
    assert sum(c["submitted"] for c in per.values()) == 24
    assert per["interactive"]["completed"] == per["interactive"]["submitted"]
    assert per["bulk"]["shed_victims"] == per["bulk"]["shed_inflight"]
    reps = report["frontdoor"]["replicas"]
    assert reps["axis"] == [1, 2] and reps["bit_identical"] is True
    for n, run in reps["runs"].items():
        assert run["completed"] == 24 and run["failed"] == 0
        assert sum(run["per_replica_routed"].values()) >= 24
        assert len(run["builds_at_ready"]) == int(n)
        assert set(run["builds_after_ready"].values()) == {0}
        assert isinstance(run["scaling_vs_1"], float)


@pytest.mark.parametrize("tamper,match", [
    (lambda s: s["overload"].update(sheds_bulk_first=False),
     "shed bulk first"),
    (lambda s: s["overload"].update(interactive_p99_ms=1e9,
                                    effective_cores=4.0), "SLO"),
    (lambda s: s["overload"].update(steady_builds=1), "native builds"),
    (lambda s: s["overload"]["per_class"]["bulk"].update(failed=1),
     "untyped/hung"),
    (lambda s: s["replicas"].update(bit_identical=False), "non-identical"),
    (lambda s: s["replicas"]["runs"]["2"]["builds_after_ready"].update(
        {"1": 2}), "after the ready handshake")])
def test_frontdoor_gate_flags_a_tampered_section(frontdoor, tamper, match):
    section = copy.deepcopy(frontdoor[1]["frontdoor"])
    tamper(section)
    violations, _ = serve_bench.gate_frontdoor(section)
    assert violations and any(match in v for v in violations), violations


@pytest.mark.parametrize("tamper,match", [
    (lambda s: s["replicas"]["runs"]["2"].update(scaling_vs_1=0.5),
     "floor"),
    (lambda s: s["overload"].update(interactive_p99_ms=1e9,
                                    effective_cores=1.1), "serial window")])
def test_host_weather_is_a_note_not_a_violation(frontdoor, tamper, match):
    """The JAX gate's two notes: a missed scaling floor, and a p99 over
    the SLO in a serial window (effective cores below 1.3)."""
    section = copy.deepcopy(frontdoor[1]["frontdoor"])
    tamper(section)
    violations, notes = serve_bench.gate_frontdoor(section)
    assert violations == [] and any(match in n for n in notes), notes


def test_session_battery_smoke(tmp_path):
    out = tmp_path / "sessions.json"
    rc = chaos_bench.main(["--smoke", "--sessions_only", "--device", "cpu",
                           "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0 and report["violations"] == []
    scenarios = report["sessions"]["scenarios"]
    assert scenarios["replica_death"]["session_orphans"] >= 1
    assert scenarios["trace_stitch"]["stitched"] is True
    assert scenarios["expire_mid_batch"]["expired_typed"] == 2
