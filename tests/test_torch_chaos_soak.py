"""The chaos bench's main soak (`run_chaos`) on the CPU at the smoke
configuration (the JAX bench's smoke configs and counts: 40 encodes, 2
worker crashes at probability 1.0, 6 corrupt streams), in process, on the
thread backend and on the process backend over the pipe (the card's phase
14 (a)), held to the JAX smoke test's invariants
(tests/test_tools_smoke.py `test_chaos_bench_smoke_json_contract`): no
hung future, no untyped error, no integrity false negative, a restored
pool after at least one restart, no native build, a non-empty flight dump,
and the JAX soak's report keys (`steady_builds` for `steady_compiles`,
the lock discipline left out with its reason). Exact.
"""

import pytest

from dsin_tpu_torch.tools import chaos_bench
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

JAX_KEYS = {"config", "warmup", "load", "faults_fired", "supervision",
            "integrity", "invariants", "flight_recorder", "lock_discipline",
            "clean_decodes_after_chaos", "steady_compiles", "duration_s",
            "violations"}


@pytest.fixture(scope="module", params=["thread", "process"])
def soak(request):
    args = chaos_bench.parse_args(["--smoke", "--device", "cpu",
                                   "--entropy_backend", request.param,
                                   "--entropy_workers", "1"])
    return request.param, chaos_bench.run_chaos(args)


def test_the_soak_holds_the_jax_smoke_invariants(soak):
    _, report = soak
    assert report["violations"] == []
    inv = report["invariants"]
    assert inv["hung_futures"] == 0
    assert inv["untyped_errors"] == 0
    assert inv["integrity_false_negatives"] == 0
    assert report["faults_fired"]["serve.worker.batch"] >= 1
    sup = report["supervision"]
    assert sup["pool_restored"] is True
    assert sup["worker_restarts"] >= 1
    assert sup["worker_crashes"] == report["faults_fired"][
        "serve.worker.batch"] == 2
    integ = report["integrity"]
    assert integ["door"]["corrupted"] > 0
    assert integ["door"]["detected"] == integ["door"]["corrupted"]
    assert integ["worker_side"]["detected"] == \
        integ["worker_side"]["corrupted"] > 0
    assert integ["false_negatives"] == 0
    assert report["steady_builds"] == 0
    assert report["load"]["completed_ok"] > 0
    assert report["clean_decodes_after_chaos"] > 0
    assert report["flight_recorder"]["dumps"] >= 1
    assert report["flight_recorder"]["last_dump_events"] >= 1


def test_the_health_transitions_end_ok(soak):
    """Sampled after each submit and after the pool's restoration: a
    restart between two samples goes unseen, so only the end is pinned."""
    _, report = soak
    seen = report["supervision"]["health_transitions"]
    assert seen[0] in ("ok", "degraded", "unhealthy") and seen[-1] == "ok"
    assert all(a != b for a, b in zip(seen, seen[1:]))


def test_the_report_keeps_the_jax_soaks_keys(soak):
    backend, report = soak
    assert set(report) == JAX_KEYS - {"steady_compiles"} | {"steady_builds"}
    assert set(report["invariants"]) == {
        "hung_futures", "untyped_errors", "integrity_false_negatives",
        "flight_dumps"}
    locks = report["lock_discipline"]
    assert locks["ported"] is False and "ranked" in locks["why"]
    cfg = report["config"]
    assert (cfg["requests"], cfg["crashes"], cfg["crash_probability"],
            cfg["corrupt_streams"]) == (40, 2, 1.0, 6)
    assert cfg["entropy_backend"] == backend and cfg["transport"] == "pipe"
    assert report["load"]["submitted"] + report["load"]["door_rejects"] == 40
