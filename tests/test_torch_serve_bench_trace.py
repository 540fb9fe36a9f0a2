"""The port's serve bench, tracing leg, on the CPU.

`gate_trace` against the JAX bench's `_gate_trace` (`tools/serve_bench.py:
1005`) on one table of sections: the same violations, word for word, but for
the builds message (native builds for XLA compiles). The one deviation is
the probe-around rule: an overhead over the 2% budget with stable pairs is a
note where any free-core probe, before or after a pair, reads below 1.3 (the
JAX gate has no such escape). A row shows it.

Then `python -m dsin_tpu_torch.tools.serve_bench --smoke --trace --device
cpu` runs in process once (module scope) at the JAX smoke's configuration
(shapes 32x48, 48x96, 64x96; buckets 48x96, 64x96; 18 requests a pass): it
exits 0, the assertions `tests/test_tools_smoke.py` pins on the JAX leg's
report hold on the port's, and the report keeps the JAX section's keys. Last,
the cross-check's unit: the tracer sums one span a batch, so a batch of
several requests counts once, and spans and accumulators agree exactly.
"""

import copy
import json

import numpy as np
import pytest

from dsin_tpu_torch.serve import CompressionService, ServiceConfig
from dsin_tpu_torch.serve import trace as trace_lib
from dsin_tpu_torch.tools import serve_bench
from dsin_tpu_torch.tools.chaos_bench import write_smoke_cfgs
from test_torch_serve_bench_si import jax_keys
from tools import serve_bench as jax_bench
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: a span's `dur_ms` holds 4 decimals: a pass's sum of them sits within a
#: few thousandths of a ms of the accumulator's unrounded sum
ROUNDING_MS = 0.005


def as_port(violation: str) -> str:
    """A JAX violation in the port's words: builds for compiles."""
    return (violation.replace("steady-state compiles", "native builds")
            .replace("leaked into jit", "leaked into the dataplane"))


def sections(overhead=0.01, pairs=(0.99, 0.99, 0.99), cores=(2.0,) * 3,
             after=None, builds=0, drift=None, names=None, dumps=1,
             path="/tmp/flight-1-0000.jsonl") -> tuple:
    """(JAX section, port section) for one row of the table."""
    cross = {k: {"span_ms": 100.0, "metric_ms": 100.0, "drift_ms": 0.0}
             for k in ("device", "entropy", "si_search")}
    if drift is not None:
        stage, span, metric = drift
        cross[stage] = {"span_ms": span, "metric_ms": metric,
                        "drift_ms": round(abs(span - metric), 3)}
    jax = {"steady_compiles": builds, "cross_check": cross,
           "sample_trace": {"span_names": sorted(
               serve_bench.SI_TRACE_SPANS if names is None else names)},
           "flight": {"dumps": dumps, "last_dump_path": path},
           "overhead": overhead, "pair_ratios": list(pairs),
           "pair_effective_cores": list(cores)}
    port = copy.deepcopy(jax)
    port["steady_builds"] = port.pop("steady_compiles")
    port["pair_effective_cores_after"] = list(cores if after is None
                                              else after)
    return jax, port


TABLE = {
    "pass": {},
    "builds with tracing on": {"builds": 3},
    "device drift beyond slack": {"drift": ("device", 180.0, 100.0)},
    "si_search drift beyond the 5 ms floor": {"drift": ("si_search", 1.0,
                                                        7.0)},
    "drift within slack": {"drift": ("entropy", 104.0, 100.0)},
    "a missing span": {"names": ("queue.wait", "batch.device",
                                 "batch.entropy", "session.lookup")},
    "no flight dump": {"dumps": 0},
    "a dump without a path": {"path": None},
    "the broken band": {"overhead": 0.3, "pairs": (0.7, 0.7, 0.7)},
    "no overhead": {"overhead": None, "pairs": ()},
    "over budget, stable pairs": {"overhead": 0.04,
                                  "pairs": (0.96, 0.96, 0.97)},
    "over budget, noisy pairs (note)": {"overhead": 0.04,
                                        "pairs": (0.9, 0.96, 1.02)},
    "everything at once": {"builds": 1, "drift": ("device", 0.0, 50.0),
                           "names": (), "dumps": 0, "overhead": 0.5,
                           "pairs": (0.5, 0.5, 0.5)},
}
PASSING = ("pass", "drift within slack", "over budget, noisy pairs (note)")


@pytest.mark.parametrize("row", TABLE)
def test_gate_trace_gives_the_jax_gates_violations(row):
    jax, port = sections(**TABLE[row])
    want = [as_port(v) for v in jax_bench._gate_trace(jax)]
    assert serve_bench.gate_trace(port) == want
    assert bool(want) == (row not in PASSING)


def test_the_probe_around_rule_is_the_one_deviation(capsys):
    # stable pairs over the budget, a load arriving during the last pair:
    # the JAX gate holds the budget; the port notes it
    jax, port = sections(overhead=0.04, pairs=(0.96, 0.96, 0.97),
                         after=(2.0, 2.0, 1.1))
    assert any("budget with stable pairs" in v
               for v in jax_bench._gate_trace(jax))
    capsys.readouterr()
    assert serve_bench.gate_trace(port) == []
    assert "serial window" in capsys.readouterr().err


def test_outside_the_smoke_only_the_hard_checks_hold():
    _, port = sections(overhead=0.6, pairs=(0.4, 0.4, 0.4))
    assert serve_bench.gate_trace(port, smoke=False) == []
    jax, port = sections(overhead=0.6, pairs=(0.4,) * 3, dumps=0)
    assert serve_bench.gate_trace(port, smoke=False) == [
        as_port(v) for v in jax_bench._gate_trace(jax)
        if "overhead" not in v]


@pytest.fixture(scope="module")
def trace_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("trace") / "trace.json"
    rc = serve_bench.main(["--smoke", "--trace", "--device", "cpu",
                           "--out", str(out)])
    return rc, json.loads(out.read_text())


def test_the_smoke_leg_passes_its_gate(trace_run):
    rc, report = trace_run
    assert rc == 0
    cfg = report["config"]
    assert (cfg["shapes"], cfg["buckets"]) == ("32,48 48,96 64,96",
                                               "48,96 64,96")
    assert (cfg["trace_requests"], cfg["trace_repeats"]) == (18, 3)


def test_the_jax_smoke_pins_hold_on_the_port(trace_run):
    # tests/test_tools_smoke.py:239-258, steady_builds for steady_compiles
    tr = trace_run[1]["trace"]
    assert tr["steady_builds"] == 0
    assert len(tr["pair_ratios"]) == tr["repeats"]
    assert tr["traced_rps"] > 0 and tr["untraced_rps"] > 0
    for stage in ("device", "entropy", "si_search"):
        c = tr["cross_check"][stage]
        assert c["span_ms"] > 0, (stage, c)
        slack = max(0.10 * max(c["metric_ms"], c["span_ms"]), 5.0)
        assert c["drift_ms"] <= slack, (stage, c)
    need = {"queue.wait", "batch.device", "batch.entropy",
            "session.lookup", "batch.si_search"}
    assert need <= set(tr["sample_trace"]["span_names"])
    assert tr["flight"]["dumps"] >= 1
    assert tr["flight"]["last_dump_path"]
    assert tr["chrome_events"] > 0


def test_spans_and_metrics_read_the_same_instants(trace_run):
    tr = trace_run[1]["trace"]
    for stage, c in tr["cross_check"].items():
        assert c["drift_ms"] <= ROUNDING_MS, (stage, c)
    assert len(tr["pair_effective_cores_after"]) == tr["repeats"]


def test_the_report_keeps_the_jax_sections_keys(trace_run):
    tr = trace_run[1]["trace"]
    want = jax_keys(jax_bench._run_trace_section)
    assert set(tr) == (set(want) - {"steady_compiles"} | {"steady_builds"}
                       | {"pair_effective_cores_after"})
    for key, nested in want.items():
        if nested:
            assert set(tr[key]) == set(nested), key
    assert set(tr["cross_check"]) == {"device", "entropy", "si_search"}
    for c in tr["cross_check"].values():
        assert set(c) == {"span_ms", "metric_ms", "drift_ms"}


def test_the_tracer_sums_one_span_a_batch(tmp_path):
    """Four encodes submitted at once form fewer batches than requests; the
    tracer's per-stage totals count each batch's span once (its trace ids
    listed in it), so they equal the accumulators, which add one stage time
    a batch, and not the sum over requests."""
    ae, pc = write_smoke_cfgs(str(tmp_path))
    svc = CompressionService(ServiceConfig(
        ae_config=ae, pc_config=pc, buckets=((48, 96),), max_batch=4,
        max_wait_ms=200.0, entropy_workers=1, trace_sample_rate=1.0,
        device="cpu")).start()
    try:
        svc.warmup()
        svc.tracer.reset()
        acc0 = svc.metrics.snapshot()["accumulators"]
        img = np.random.default_rng(0).integers(0, 255, (48, 96, 3),
                                                dtype=np.uint8)
        futures = [svc.submit_encode(img) for _ in range(4)]
        for f in futures:
            f.result(timeout=60)
        serve_bench._quiesce(svc)
        acc1 = svc.metrics.snapshot()["accumulators"]
        spans = svc.tracer.snapshot()["spans"]
    finally:
        svc.drain()
    device = [s for s in spans if s["name"] == trace_lib.SPAN_DEVICE]
    assert len(device) < 4 and sum(len(s["tids"]) for s in device) == 4
    totals = svc.tracer.stage_totals_ms()
    for name, acc in ((trace_lib.SPAN_DEVICE, "serve_device_ms_total"),
                      (trace_lib.SPAN_ENTROPY, "serve_entropy_ms_total")):
        metric = acc1[acc] - acc0.get(acc, 0.0)
        assert abs(totals[name] - metric) <= ROUNDING_MS, (name, totals)
        per_request = sum(s["dur_ms"] * len(s["tids"]) for s in spans
                          if s["name"] == name)
        assert per_request > metric + 1.0, (name, per_request, metric)
