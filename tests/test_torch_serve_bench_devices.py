"""The port's serve bench, device axis, on the CPU.

`python -m dsin_tpu_torch.tools.serve_bench --devices "1 2" --devices_only
--smoke`'s leg runs in process once (module scope) at the tiny
configuration of tests/test_train_step.py, buckets (16, 24) and (32, 48),
8 encodes submitted at once and 2 decodes: one warm service at one
logical CPU device, one at two (`devices=("cpu", "cpu")`). The JSON
contract holds, each device of the two served, no build in the stream
window, the gate passes; then the gate is shown to flag each tampered
section, and the axis to refuse another leg beside `--devices_only`.
Exact.
"""

import copy
import json

import pytest

from dsin_tpu_torch.tools import serve_bench
from test_train_step import tiny_ae_cfg, tiny_pc_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RUN_KEYS = {"devices", "throughput_rps", "completed", "failed",
            "decode_roundtrips", "steady_builds", "warmup", "census",
            "executable_census", "per_device", "all_devices_served",
            "scaling_vs_1"}


@pytest.fixture(scope="module")
def axis(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_devices")
    ae_p, pc_p = str(root / "ae"), str(root / "pc")
    with open(ae_p, "w") as f:
        f.write(str(tiny_ae_cfg(crop_size=(16, 24), batch_size=1)))
    with open(pc_p, "w") as f:
        f.write(str(tiny_pc_cfg()))
    out = root / "bench.json"
    rc = serve_bench.main([
        "--devices", "1 2", "--devices_only", "--out", str(out),
        "--device", "cpu", "--ae_config", ae_p, "--pc_config", pc_p,
        "--buckets", "16,24 32,48", "--shapes", "16,24 32,48 10,17",
        "--requests", "8", "--rate", "1000", "--decode_samples", "2",
        "--entropy_workers", "1", "--max_wait_ms", "20"])
    return rc, json.loads(out.read_text())


def test_the_axis_passes_its_gate(axis):
    rc, report = axis
    assert rc == 0
    assert serve_bench.gate_device_axis(report["devices"], smoke=True) == []


def test_json_contract(axis):
    _, report = axis
    section = report["devices"]
    assert section["axis"] == [1, 2] and section["skipped"] == {}
    assert report["config"]["devices_axis"] == [1, 2]
    assert set(section["runs"]) == {"1", "2"}
    for n, run in section["runs"].items():
        assert set(run) == RUN_KEYS
        assert run["devices"] == ["cpu"] * int(n)
        assert run["completed"] == 8 and run["failed"] == 0
        assert run["decode_roundtrips"] == 2
        assert run["steady_builds"] == 0 and run["warmup"]["builds"] == 0
        assert set(run["per_device"]) == {str(d) for d in range(int(n))}
        assert run["all_devices_served"] is True
        pairs = sum(len(v) for v in run["census"].values())
        assert run["executable_census"] == 2 * pairs
        assert sum(v["batches"] for v in run["per_device"].values()) > 0
        for v in run["per_device"].values():
            assert 0.0 < v["occupancy"] <= 1.0 and v["busy_ms"] > 0
    assert section["runs"]["1"]["census"] == {"16x24": [0], "32x48": [0]}
    assert section["runs"]["2"]["census"] == {"16x24": [0], "32x48": [1]}
    assert section["runs"]["1"]["scaling_vs_1"] == 1.0
    assert isinstance(section["runs"]["2"]["scaling_vs_1"], float)


@pytest.mark.parametrize("tamper,match", [
    (lambda s: s["runs"]["2"].update(steady_builds=1), "native builds"),
    (lambda s: (s["runs"]["2"].update(all_devices_served=False),
                s["runs"]["2"]["per_device"]["1"].update(batches=0)),
     "served zero batches"),
    (lambda s: s["runs"]["1"].update(failed=3), "requests failed"),
    (lambda s: s["skipped"].update({"4": "refused"}), "was skipped")])
def test_the_gate_flags_a_tampered_section(axis, tamper, match):
    section = copy.deepcopy(axis[1]["devices"])
    tamper(section)
    violations = serve_bench.gate_device_axis(section, smoke=True)
    assert violations and any(match in v for v in violations), violations


def test_a_skip_outside_the_smoke_is_recorded_not_gated(axis):
    section = copy.deepcopy(axis[1]["devices"])
    section["skipped"]["4"] = "refused"
    assert serve_bench.gate_device_axis(section) == []


def test_devices_only_runs_alone(tmp_path):
    with pytest.raises(SystemExit):
        serve_bench.main(["--devices_only", "--precision", "--out",
                          str(tmp_path / "o.json"), "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve_bench.main(["--devices", "0 2", "--out",
                          str(tmp_path / "o.json"), "--device", "cpu"])
    assert serve_bench.logical_devices("cpu", 3) == ("cpu",) * 3
    assert serve_bench.logical_devices("cuda", 2) == ("cuda:0",) * 2
