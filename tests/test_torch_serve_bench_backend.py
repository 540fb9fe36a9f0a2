"""The port's serve bench, entropy-backend and transport legs, on the CPU.

`python -m dsin_tpu_torch.tools.serve_bench --entropy_backend both
--transport both` runs in process once (module scope) at the tiny
configuration of tests/test_train_step.py, one (128, 144) bucket, 8
encodes submitted at once and 2 decodes, one entropy worker: the thread
and process backends, then the process backend on pipe and on shm. The
JSON contract holds, both legs' streams are byte-equal, the shm run sent
lanes, and the gates pass; then each gate is shown to flag a tampered
section. Exact.
"""

import copy
import json

import pytest

from dsin_tpu_torch.tools import serve_bench
from test_train_step import tiny_ae_cfg, tiny_pc_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RUN_KEYS = {"throughput_rps", "completed", "failed", "steady_builds",
            "decode_roundtrips", "entropy_workers", "warmup", "latency_ms",
            "stages", "overlap_ratio", "effective_cores", "worker_pids",
            "shm", "pool_rebuilds"}


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_backend")
    ae_p, pc_p = str(root / "ae"), str(root / "pc")
    with open(ae_p, "w") as f:
        f.write(str(tiny_ae_cfg(crop_size=(16, 24), batch_size=1)))
    with open(pc_p, "w") as f:
        f.write(str(tiny_pc_cfg()))
    out = root / "bench.json"
    rc = serve_bench.main([
        "--entropy_backend", "both", "--transport", "both", "--out",
        str(out), "--device", "cpu", "--ae_config", ae_p, "--pc_config",
        pc_p, "--buckets", "128,144", "--shapes", "128,144 120,130",
        "--requests", "8", "--rate", "1000", "--decode_samples", "2",
        "--entropy_workers", "1", "--max_wait_ms", "50"])
    return rc, json.loads(out.read_text())


def test_legs_pass_their_gates(legs):
    rc, report = legs
    assert rc == 0
    assert serve_bench.gate_backend_axis(report["backend"]) == []
    assert serve_bench.gate_transport(report["transport"]) == []


def test_json_contract(legs):
    _, report = legs
    host = report["host"]
    assert host["card"] is None            # the CPU: no card line
    assert host["cpu_count"] >= 1 and host["affinity_cores"] >= 1
    backend = report["backend"]
    assert backend["axis"] == ["thread", "process"]
    assert backend["bit_identical"] is True
    assert isinstance(backend["process_vs_thread"], float)
    transport = report["transport"]
    assert transport["axis"] == ["pipe", "shm"]
    assert transport["entropy"]["bit_identical"] is True
    runs = [backend["runs"]["thread"], backend["runs"]["process"],
            transport["entropy"]["runs"]["pipe"],
            transport["entropy"]["runs"]["shm"]]
    for run in runs:
        assert set(run) == RUN_KEYS
        assert run["completed"] == 8 and run["failed"] == 0
        assert run["decode_roundtrips"] == 2
        assert run["steady_builds"] == 0 and run["pool_rebuilds"] == 0
        assert run["warmup"]["builds"] == 0
    assert backend["runs"]["thread"]["worker_pids"] == []
    assert len(backend["runs"]["process"]["worker_pids"]) == 1
    shm = transport["entropy"]["runs"]["shm"]["shm"]
    assert shm["sends"] > 0
    assert shm["fallbacks"] == 0 and shm["integrity_errors"] == 0
    assert transport["entropy"]["runs"]["pipe"]["shm"]["sends"] == 0


@pytest.mark.parametrize("tamper,match", [
    (lambda b: b.update(bit_identical=False), "different bytes"),
    (lambda b: b["runs"]["process"].update(steady_builds=1),
     "native builds"),
    (lambda b: b["runs"]["thread"].update(failed=2), "requests failed")])
def test_backend_gate_flags_a_tampered_section(legs, tamper, match):
    section = copy.deepcopy(legs[1]["backend"])
    tamper(section)
    violations = serve_bench.gate_backend_axis(section)
    assert violations and any(match in v for v in violations), violations


@pytest.mark.parametrize("tamper,match", [
    (lambda t: t["entropy"].update(bit_identical=False), "different bytes"),
    (lambda t: t["entropy"]["runs"]["shm"]["shm"].update(sends=0),
     "zero lane sends"),
    (lambda t: t["entropy"]["runs"]["shm"]["shm"].update(
        integrity_errors=1), "integrity"),
    (lambda t: t["entropy"]["runs"]["pipe"].update(steady_builds=3),
     "native builds")])
def test_transport_gate_flags_a_tampered_section(legs, tamper, match):
    section = copy.deepcopy(legs[1]["transport"])
    tamper(section)
    violations = serve_bench.gate_transport(section)
    assert violations and any(match in v for v in violations), violations


def test_a_leg_must_be_chosen(tmp_path):
    with pytest.raises(SystemExit):
        serve_bench.main(["--out", str(tmp_path / "o.json"),
                          "--device", "cpu"])
