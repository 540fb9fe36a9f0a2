"""The serve bench's fleet legs on the CPU at the smoke configuration:
`python -m dsin_tpu_torch.tools.serve_bench --smoke --device cpu` with
`--autoscale` (1 -> 2 -> 1 spawned replicas under load, then a template
admit) and with `--federation_only --members 2` (two single-replica
spawned member fleets behind one FederatedRouter), each run once in
process (module scope; the children at one torch thread). Both exit 0
and pass their gates, the JSON contracts hold, and each gate flags a
tampered section. Exact.
"""

import copy
import json
import os

import pytest

from dsin_tpu_torch.tools import serve_bench
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _run(tmp_path_factory, name, flags):
    out = tmp_path_factory.mktemp(name) / "bench.json"
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"     # the spawned replicas inherit it
    try:
        rc = serve_bench.main(["--smoke", "--device", "cpu", "--out",
                               str(out), *flags])
    finally:
        if before is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = before
    return rc, json.loads(out.read_text())


@pytest.fixture(scope="module")
def autoscale(tmp_path_factory):
    return _run(tmp_path_factory, "bench_autoscale", ["--autoscale"])


@pytest.fixture(scope="module")
def federation(tmp_path_factory):
    return _run(tmp_path_factory, "bench_federation",
                ["--federation_only", "--members", "2"])


def test_autoscale_leg_passes_its_gate(autoscale):
    rc, report = autoscale
    assert rc == 0
    violations, _ = serve_bench.gate_autoscale(report["autoscale"])
    assert violations == []


def test_autoscale_json_contract(autoscale):
    sec = autoscale[1]["autoscale"]
    assert sec["top_replicas"] == 2
    assert sec["scale_ups"] == sec["scale_downs"] == 1
    assert sec["bit_identical"] is True and sec["failed"] == 0
    assert sec["completed"] + sec["rejected_inflight"] == sec["submitted"]
    assert set(sec["builds_after_ready"].values()) == {0}
    assert set(sec["builds_at_ready"].values()) == {0}
    admit = sec["admits"][0]
    assert admit["decision_to_traffic_s"] >= admit["admit_s"] > 0
    tpl = sec["template"]
    assert tpl["template_admit"] is True and tpl["template_admits"] == 1
    assert tpl["builds_after_ready"] == 0 and tpl["bit_identical"] is True
    assert tpl["cold_admit_s"] == admit["admit_s"]


@pytest.mark.parametrize("tamper,match", [
    (lambda s: s.update(scale_ups=0), "scale_ups"),
    (lambda s: s.update(bit_identical=False), "bit-identity"),
    (lambda s: s["builds_after_ready"].update({"1": 3}), "natively"),
    (lambda s: s["builds_after_ready"].update({"1": None}), "no build"),
    (lambda s: s.update(failed=2), "untyped/hung"),
    (lambda s: s["template"].update(template_admit=False), "template"),
    (lambda s: s["template"].update(decision_to_traffic_s=1e6,
                                    effective_cores=4.0), "budget")])
def test_autoscale_gate_flags_a_tampered_section(autoscale, tamper, match):
    section = copy.deepcopy(autoscale[1]["autoscale"])
    tamper(section)
    violations, _ = serve_bench.gate_autoscale(section)
    assert violations and any(match in v for v in violations), violations


def test_a_slow_template_in_a_serial_window_is_a_note(autoscale):
    section = copy.deepcopy(autoscale[1]["autoscale"])
    section["template"].update(decision_to_traffic_s=1e6,
                               effective_cores=1.1)
    violations, notes = serve_bench.gate_autoscale(section)
    assert violations == [] and any("serial window" in n for n in notes)


def test_federation_leg_passes_its_gate(federation):
    rc, report = federation
    assert rc == 0
    assert serve_bench.gate_federation(report["federation"]) == []


def test_federation_json_contract(federation):
    sec = federation[1]["federation"]
    assert sec["members"] == ["m0", "m1"]
    for door in ("direct", "federated"):
        leg = sec["routing"][door]
        assert leg["failed"] == 0 and leg["completed"] == leg["submitted"]
    ro = sec["rollout"]
    assert ro["waves"] == [["m0"], ["m1"]] and ro["torn_versions"] == []
    assert set(ro["per_member_digests"].values()) == {ro["digest_b"]}
    assert ro["digest_b"] != ro["digest_a"] and ro["promote_s"] > 0
    assert ro["distributed_roots_staged"] == {"m1": True}
    assert sec["bit_identical"] == {"before_rollout": True,
                                    "after_rollout": True}
    assert sec["scrape_fanout"]["members_scraped"] == 2
    counters = sec["federation_counters"]
    assert counters["federation_rollout_waves"] == 2
    assert counters["federation_rollout_promotions"] == 1
    assert sec["bench_process_builds"] == 0


@pytest.mark.parametrize("tamper,match", [
    (lambda s: s["rollout"].update(torn_versions=["m1='x'"]), "torn"),
    (lambda s: s["rollout"].update(digest_b=s["rollout"]["digest_a"]),
     "did not move"),
    (lambda s: s["bit_identical"].update(after_rollout=False),
     "after rollout"),
    (lambda s: s["routing"]["federated"].update(failed=1), "untyped/hung"),
    (lambda s: s["scrape_fanout"].update(members_unreachable=["m1"]),
     "missed members"),
    (lambda s: s["builds_after_ready"]["m1"].update({"0": 1}),
     "after ready"),
    (lambda s: s["rollout"]["distributed_roots_staged"].update(m1=False),
     "replicate_checkpoint")])
def test_federation_gate_flags_a_tampered_section(federation, tamper, match):
    section = copy.deepcopy(federation[1]["federation"])
    tamper(section)
    violations = serve_bench.gate_federation(section)
    assert violations and any(match in v for v in violations), violations
