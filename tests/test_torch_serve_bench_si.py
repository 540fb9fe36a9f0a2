"""The port's serve bench, SI leg, on the CPU.

`gate_si` against the JAX bench's `_gate_si` (`tools/serve_bench.py:767`) on
one table of sections: the same violations, word for word, but for the
builds message (native builds for XLA compiles). The one deviation is the
probe-around rule: the port reads a free-core probe before AND after every
pair and notes the floor where any probe reads below 1.3 (ROADMAP's standing
gate); the JAX gate reads the median of one probe a pair. A row shows it.

Then `python -m dsin_tpu_torch.tools.serve_bench --smoke --si_only --device
cpu` runs in process once (module scope) at the JAX smoke's configuration
(shapes 32x48, 48x96, 64x96; buckets 48x96, 64x96; 20 decode_si requests a
pass): it exits 0 under the JAX floor, the assertions
`tests/test_tools_smoke.py` pins on the JAX leg's report hold on the port's,
and the report keeps the JAX section's keys (read from the JAX function's
return statement), `steady_compiles` renamed `steady_builds`, plus the
port's extras listed below.
"""

import ast
import copy
import inspect
import json

import pytest

from dsin_tpu_torch.tools import serve_bench
from tools import serve_bench as jax_bench
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: the port's keys beyond the JAX section's: the probes after each pair, the
#: store's budget and what a warm pass held, whether the two modes gave the
#: same image
SI_EXTRAS = {"pair_effective_cores_after", "session_max_bytes",
             "warm_session_bytes", "modes_bit_equal"}


def jax_keys(func) -> dict:
    """{key: nested keys or None} of the dict literal `func` returns; a name
    in its place resolves to the dict literal assigned to it in `func`."""
    tree = ast.parse(inspect.getsource(func))
    assigned = {n.targets[0].id: n.value for n in ast.walk(tree)
                if isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and isinstance(n.value, ast.Dict)}

    def keys(node):
        if isinstance(node, ast.Name):
            node = assigned.get(node.id)
        if not isinstance(node, ast.Dict):
            return None
        return {k.value: keys(v) for k, v in zip(node.keys, node.values)
                if isinstance(k, ast.Constant)}

    ret = tree.body[0].body[-1]       # the function's last statement
    assert isinstance(ret, ast.Return)
    return keys(ret.value)


def as_port(violation: str) -> str:
    """A JAX violation in the port's words: builds for compiles."""
    return (violation.replace("steady-state compiles", "native builds")
            .replace("warmed executables", "warmed kernels"))


def sections(speedup=1.3, cores=(2.0, 2.0, 2.0), after=None, failed=(0, 0),
             builds=0, evictions=8, untyped=0) -> tuple:
    """(JAX section, port section) for one row of the table."""
    jax = {"warm": {"failed": failed[0]},
           "per_request_prep": {"failed": failed[1]},
           "steady_compiles": builds,
           "churn": {"evictions": evictions, "untyped": untyped},
           "speedup": speedup,
           "pair_speedups": [speedup] * 3 if speedup else [],
           "pair_effective_cores": list(cores)}
    port = copy.deepcopy(jax)
    port["steady_builds"] = port.pop("steady_compiles")
    port["pair_effective_cores_after"] = list(cores if after is None
                                              else after)
    return jax, port


TABLE = {
    "pass": {},
    "warm failed": {"failed": (2, 0)},
    "per-request prep failed": {"failed": (0, 3)},
    "builds while churning": {"builds": 2},
    "churn never evicted": {"evictions": 0},
    "untyped churn error": {"untyped": 1},
    "below the floor with headroom": {"speedup": 1.05},
    "no speedup": {"speedup": None},
    "below the floor in a serial window (note)":
        {"speedup": 1.05, "cores": (1.0, 1.1, 0.9)},
    "at the floor": {"speedup": 1.1},
    "everything at once": {"failed": (1, 1), "builds": 1, "evictions": 0,
                           "untyped": 2, "speedup": 0.8},
}


@pytest.mark.parametrize("row", TABLE)
def test_gate_si_gives_the_jax_gates_violations(row):
    jax, port = sections(**TABLE[row])
    want = [as_port(v) for v in jax_bench._gate_si(jax)]
    assert serve_bench.gate_si(port) == want
    assert bool(want) == (row not in (
        "pass", "at the floor", "below the floor in a serial window (note)"))


def test_the_probe_around_rule_is_the_one_deviation(capsys):
    # headroom before every pair, a load arriving during the second: the
    # JAX gate (one probe a pair, before it) holds the floor; the port,
    # probing after each pair too, notes it
    jax, port = sections(speedup=1.05, after=(2.0, 1.0, 2.0))
    assert any("floor 1.1" in v for v in jax_bench._gate_si(jax))
    capsys.readouterr()
    assert serve_bench.gate_si(port) == []
    assert "SERVE_BENCH_NOTE" in capsys.readouterr().err


def test_outside_the_smoke_only_the_hard_checks_hold():
    _, port = sections(speedup=0.5)
    assert serve_bench.gate_si(port, smoke=False) == []
    _, port = sections(speedup=0.5, builds=1)
    assert serve_bench.gate_si(port, smoke=False) == [
        as_port(v) for v in jax_bench._gate_si(sections(builds=1)[0])]


@pytest.fixture(scope="module")
def si_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("si") / "si.json"
    rc = serve_bench.main(["--smoke", "--si_only", "--device", "cpu",
                           "--out", str(out)])
    return rc, json.loads(out.read_text())


def test_the_smoke_leg_passes_its_gate(si_run):
    rc, report = si_run
    assert rc == 0
    cfg = report["config"]
    assert (cfg["shapes"], cfg["buckets"]) == ("32,48 48,96 64,96",
                                               "48,96 64,96")
    assert (cfg["si_requests"], cfg["si_repeats"]) == (20, 3)


def test_the_jax_smoke_pins_hold_on_the_port(si_run):
    # tests/test_tools_smoke.py:221-238, steady_builds for steady_compiles
    si = si_run[1]["si"]
    assert si["warm"]["failed"] == 0
    assert si["per_request_prep"]["failed"] == 0
    assert si["warm"]["latency_ms"]["count"] > 0
    assert si["per_request_prep"]["latency_ms"]["p50"] > 0
    assert si["steady_builds"] == 0
    assert len(si["pair_speedups"]) == si["repeats"]
    assert si["speedup"] >= 0.9, si
    assert si["churn"]["evictions"] > 0
    assert si["churn"]["untyped"] == 0
    assert si["churn"]["decodes_ok"] > 0
    assert si["prep_ms"]["count"] > 0
    assert si["search_ms"]["count"] > 0


def test_the_port_reports_what_the_jax_leg_does_not(si_run):
    si = si_run[1]["si"]
    assert si["modes_bit_equal"] is True
    assert len(si["pair_effective_cores_after"]) == si["repeats"]
    churn = si["churn"]
    # at the smoke size the preps are small: session_max evicts
    assert sum(churn["evictions_by_reason"].values()) == churn["evictions"]
    assert set(churn["evictions_by_reason"]) == {"lru"}
    assert churn["decodes_ok"] + churn["expired_typed"] == sum(
        min(k + 1, serve_bench.SI_CHURN_WINDOW)
        for k in range(serve_bench.SI_CHURN_OPENS))
    assert 0 < si["warm_session_bytes"] <= si["session_max_bytes"]
    assert si["session_max"] == serve_bench.SI_SESSION_MAX
    assert si["sessions_opened"] == (
        si["repeats"] * (len(si_run[1]["config"]["buckets"].split())
                         + si["requests_per_mode"])
        + serve_bench.SI_CHURN_OPENS)


def test_the_report_keeps_the_jax_sections_keys(si_run):
    si = si_run[1]["si"]
    want = jax_keys(jax_bench._run_si_section)
    assert set(si) == (set(want) - {"steady_compiles"} | {"steady_builds"}
                       | SI_EXTRAS)
    for key, nested in want.items():
        if nested:
            extra = {"evictions_by_reason"} if key == "churn" else set()
            assert set(si[key]) == set(nested) | extra, key


def test_si_only_and_trace_run_without_the_other_legs(tmp_path):
    for argv in (["--si_only", "--precision"], ["--trace", "--quality"],
                 ["--si_only", "--devices", "1 2"]):
        with pytest.raises(SystemExit):
            serve_bench.main(argv + ["--out", str(tmp_path / "o.json"),
                                     "--device", "cpu"])

