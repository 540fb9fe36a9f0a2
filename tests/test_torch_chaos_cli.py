"""The chaos bench's command line, with every `run_*` stubbed so only the
dispatch runs: the bare call runs the soak and then the six batteries in
the JAX main's order (`tools/chaos_bench.py:2598-2604`), each `*_only`
flag runs its battery alone, any battery's violations gate the exit code,
the report goes to `--out` (default CHAOS_BENCH_TORCH.json, never the JAX
bench's CHAOS_BENCH.json), and `--smoke` applies the JAX smoke counts.
Exact.
"""

import json

import pytest

from dsin_tpu_torch.tools import chaos_bench
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ORDER = ["chaos", "hotswap", "sessions", "degraded", "autoscale",
         "transport", "federation"]
SECTIONS = {"hotswap": "hotswap", "sessions": "sessions",
            "degraded": "degraded_model", "autoscale": "autoscale",
            "transport": "transport", "federation": "federation"}


@pytest.fixture
def stubs(monkeypatch):
    """Stub every runner; `fail` names runners that report a violation.
    -> (calls, fail, seen args)."""
    calls, fail, seen = [], set(), []

    def stub(name):
        def run(args):
            calls.append(name)
            seen.append(args)
            bad = [f"{name} broke"] if name in fail else []
            if name == "chaos":
                return {"config": {"soak": True}, "violations": bad}
            return {"scenarios": {}, "violations": bad}
        return run

    for name in ORDER:
        monkeypatch.setattr(chaos_bench, f"run_{name}", stub(name))
    return calls, fail, seen


def test_the_bare_call_runs_the_soak_then_all_six_in_order(stubs, tmp_path):
    calls, _, _ = stubs
    out = tmp_path / "c.json"
    assert chaos_bench.main(["--smoke", "--device", "cpu", "--out",
                             str(out)]) == 0
    assert calls == ORDER
    report = json.loads(out.read_text())
    assert report["config"] == {"soak": True}
    assert set(SECTIONS.values()) <= set(report)
    assert report["violations"] == []


@pytest.mark.parametrize("name", ORDER[1:])
def test_each_only_flag_runs_its_battery_alone(stubs, tmp_path, name):
    calls, _, _ = stubs
    flag = {"degraded": "--degraded_only"}.get(name, f"--{name}_only")
    out = tmp_path / "c.json"
    assert chaos_bench.main(["--smoke", "--device", "cpu", flag, "--out",
                             str(out)]) == 0
    assert calls == [name]
    report = json.loads(out.read_text())
    assert set(report) == {"config", "violations", SECTIONS[name]}


@pytest.mark.parametrize("broken", ORDER)
def test_every_batterys_violations_gate_the_exit_code(stubs, tmp_path,
                                                      broken, capsys):
    calls, fail, _ = stubs
    fail.add(broken)
    out = tmp_path / "c.json"
    assert chaos_bench.main(["--smoke", "--device", "cpu", "--out",
                             str(out)]) == 1
    assert calls == ORDER           # a failed battery stops nothing
    assert json.loads(out.read_text())["violations"] == [f"{broken} broke"]
    assert "CHAOS_BENCH_FAILED" in capsys.readouterr().err


def test_smoke_takes_the_jax_smoke_counts_and_the_default_out(stubs,
                                                              tmp_path,
                                                              monkeypatch):
    _, _, seen = stubs
    monkeypatch.chdir(tmp_path)
    assert chaos_bench.main(["--smoke", "--device", "cpu",
                             "--transport_only"]) == 0
    args = seen[0]
    assert (args.requests, args.crashes, args.crash_probability,
            args.corrupt_streams) == (40, 2, 1.0, 6)
    assert args.out == "CHAOS_BENCH_TORCH.json"
    assert (tmp_path / "CHAOS_BENCH_TORCH.json").exists()
    full = chaos_bench.parse_args(["--device", "cpu"])
    assert (full.requests, full.crashes, full.crash_probability,
            full.corrupt_streams, full.transport) == (120, 4, 0.08, 12,
                                                      "pipe")


def test_members_below_two_is_refused(stubs):
    with pytest.raises(SystemExit):
        chaos_bench.main(["--smoke", "--device", "cpu", "--members", "1"])
    assert stubs[0] == []
