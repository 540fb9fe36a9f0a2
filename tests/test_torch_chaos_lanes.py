"""The chaos bench's shared-memory lane battery (`run_transport`) on the
CPU at the smoke configuration, through the CLI
(`python -m dsin_tpu_torch.tools.chaos_bench --smoke --transport_only
--device cpu`), with spawned replicas: every single-bit flip of a lane
frame in the mapped segment raises typed, the three lying descriptors are
refused, a one-lane burst falls back typed and counted with every request
served, a SIGKILLed replica with descriptors in flight leaves no hung
future and the survivor serving, and the /dev/shm census of this process's
segments is unchanged. Held to the JAX smoke test's pins
(tests/test_tools_smoke.py, the `transport` section). Exact.
"""

import json
import os

import pytest

from dsin_tpu_torch.serve import shmlane
from dsin_tpu_torch.tools import chaos_bench
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def battery(tmp_path_factory):
    out = tmp_path_factory.mktemp("lanes") / "t.json"
    rc = chaos_bench.main(["--smoke", "--transport_only", "--device", "cpu",
                           "--entropy_workers", "1", "--out", str(out)])
    return rc, json.loads(out.read_text())


def test_the_battery_passes_through_the_cli(battery):
    rc, report = battery
    assert rc == 0 and report["violations"] == []
    assert set(report) == {"config", "transport", "violations"}
    tr = report["transport"]
    assert tr["violations"] == []
    assert set(tr["scenarios"]) == {"lane_corruption", "lane_exhaustion",
                                    "replica_death_mid_descriptor"}


def test_every_flip_and_every_liar_is_refused(battery):
    lc = battery[1]["transport"]["scenarios"]["lane_corruption"]
    assert lc["flips_caught"] == lc["frame_bits"] == \
        (shmlane.FRAME_OVERHEAD + 96) * 8
    assert lc["pristine_readback"] is True
    assert lc["geometry_refusals"] == lc["expected_geometry_refusals"] == 3


def test_exhaustion_falls_back_typed_and_serves(battery):
    le = battery[1]["transport"]["scenarios"]["lane_exhaustion"]
    assert le["fallback_exhausted"] >= 1 and le["lane_sends"] >= 1
    assert le["hung_futures"] == 0 and le["untyped_errors"] == 0
    assert le["completed_ok"] == le["submitted"] == 40
    assert le["integrity_errors"] == 0


def test_a_replica_death_leaves_no_hung_future_and_no_segment(battery):
    tr = battery[1]["transport"]
    rd = tr["scenarios"]["replica_death_mid_descriptor"]
    assert rd["replica_deaths"] >= 1
    assert rd["hung_futures"] == 0 and rd["untyped_errors"] == 0
    assert rd["submitted"] == 16
    assert tr["shm_census"]["after"] == tr["shm_census"]["before"]
    # the battery's own ring and its routers' rings were all made here
    assert len(shmlane.created_segments()) >= 1 + 2 + 4


def test_no_replica_launched_a_kernel(battery):
    """No SI traffic: the replicas' kernel counts stay 0."""
    launches = battery[1]["transport"]["replica_kernel_launches"]
    assert set(launches) == {"lane_exhaustion",
                             "replica_death_mid_descriptor"}
    assert len(launches["replica_death_mid_descriptor"]) == 2
    for per in launches.values():
        for counts in per.values():
            assert counts and set(counts.values()) == {0}


def test_the_census_sees_a_leak():
    ring = shmlane.LaneRing.create("census", [shmlane.LaneClass("c", 64, 1)])
    try:
        assert ring.name in chaos_bench.shm_census()
        assert os.path.exists(os.path.join("/dev/shm", ring.name))
    finally:
        ring.unlink()
    assert ring.name not in chaos_bench.shm_census()
    assert ring.name in shmlane.created_segments()
