"""The port's serve-bench precision leg at the tiny configuration on the CPU.

Runs `python -m dsin_tpu_torch.tools.serve_bench --precision` in process with
`--device cpu --reps 2` (a few seconds): the JSON keeps the JAX leg's shape,
every stage has a positive time, the streams of both modes are byte-identical
across the three rungs and round-trip, nothing is built in the timed window,
and the gate flags a tampered section.
"""

import copy
import json

import pytest

from dsin_tpu_torch.coding import precision as precision_lib
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.tools import serve_bench
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def leg(tmp_path_factory):
    d = tmp_path_factory.mktemp("precision_leg")
    ae, pc = tiny_configs()
    (d / "ae").write_text(str(ae))
    (d / "pc").write_text(str(pc))
    out = d / "leg.json"
    rc = serve_bench.main(["--precision", "--out", str(out), "--device",
                           "cpu", "--reps", "2", "--bucket", "40,48",
                           "--ae_config", str(d / "ae"), "--pc_config",
                           str(d / "pc")])
    return rc, json.loads(out.read_text())


def test_leg_passes_its_gate_on_the_cpu(leg):
    rc, report = leg
    section = report["precision"]
    assert rc == 0
    assert serve_bench.gate_precision(section) == []
    assert section["rungs"] == list(precision_lib.RUNGS)
    assert section["bucket"] == [40, 48]
    assert section["reps"] == 2 and section["batch"] == 2
    assert section["device"] == "cpu" and section["clock"] == "host"
    assert section["streams_bit_identical"] is True
    for rung, entry in section["per_rung"].items():
        assert entry["compute_dtype"] == \
            precision_lib.PrecisionPolicy(rung).compute_dtype
        assert list(entry["stage_device_ms"]) == list(serve_bench.STAGES)
        assert all(ms > 0 for ms in entry["stage_device_ms"].values())
        assert entry["steady_builds"] == 0
        assert entry["roundtrip_ok"] == {m: True for m in serve_bench.MODES}
        assert set(entry["stream_sha256"]) == set(serve_bench.MODES)


@pytest.mark.parametrize("tamper,match", [
    (lambda s: s["per_rung"].pop("int8"), "int8 missing"),
    (lambda s: s["per_rung"]["bf16"]["stage_device_ms"].update(
        epilogue_kernel=0.0), "epilogue_kernel"),
    (lambda s: s["per_rung"]["bf16"]["stage_device_ms"].pop("si_search"),
     "si_search"),
    (lambda s: s["per_rung"]["fp32"].update(steady_builds=1), "built 1"),
    (lambda s: s["per_rung"]["int8"]["roundtrip_ok"].update(
        wavefront_pl=False), "round-trip"),
    (lambda s: s.update(streams_bit_identical=False), "divergence"),
])
def test_gate_flags_a_tampered_section(leg, tamper, match):
    section = copy.deepcopy(leg[1]["precision"])
    tamper(section)
    violations = serve_bench.gate_precision(section)
    assert violations and any(match in v for v in violations), violations


def test_leg_exits_1_on_a_violation(leg, monkeypatch, tmp_path, capsys):
    bad = copy.deepcopy(leg[1]["precision"])
    bad["streams_bit_identical"] = False
    monkeypatch.setattr(serve_bench, "run_precision_section",
                        lambda *a, **k: bad)
    rc = serve_bench.main(["--precision", "--out", str(tmp_path / "o.json"),
                           "--device", "cpu", "--bucket", "40,48"])
    assert rc == 1
    assert "SERVE_BENCH_FAILED" in capsys.readouterr().err


def test_leg_defaults_to_the_card(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_bench.main(["--precision", "--out", str(tmp_path / "o.json"),
                          "--bucket", "40,48"])
