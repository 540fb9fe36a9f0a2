"""The chaos bench's fleet batteries on the CPU at the smoke
configuration, replicas on threads of this process:
`python -m dsin_tpu_torch.tools.chaos_bench --smoke --device cpu` with
`--autoscale_only` (burst scale-up by the Autoscaler, the fleet-health
rollback of a canary-failing model, an idle drain orphaning a pinned
session, a death during a scale-up) and with `--federation_only
--members 2` (trace stitching, a two-wave rollout, a wave canary
failure, a partition mid-rollout healed through the aborted digest, a
member's death with pinned sessions). Each exits 0 with no violation
and reports every scenario. Exact.
"""

import json

import pytest

from dsin_tpu_torch.tools import chaos_bench
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def batteries(tmp_path_factory):
    root = tmp_path_factory.mktemp("chaos_fleet")
    out = {}
    for name, flags in (("autoscale", ["--autoscale_only"]),
                        ("federation", ["--federation_only", "--members",
                                        "2"])):
        path = root / f"{name}.json"
        rc = chaos_bench.main(["--smoke", "--device", "cpu",
                               "--entropy_workers", "1", "--out", str(path),
                               *flags])
        out[name] = (rc, json.loads(path.read_text()))
    return out


@pytest.mark.parametrize("name,scenarios", [
    ("autoscale", {"scale_up_burst", "sick_model_fleet_rollback",
                   "drain_down_idle", "death_during_scale_up"}),
    ("federation", {"federation_trace_stitch", "staged_rollout",
                    "wave_canary_failure", "partition_mid_rollout",
                    "member_death_pinned_sessions"})])
def test_fleet_battery_passes(batteries, name, scenarios):
    rc, report = batteries[name]
    assert rc == 0 and report["violations"] == []
    assert set(report[name]["scenarios"]) == scenarios
    assert report[name]["steady_builds"] == 0
    assert report[name]["flight_recorder"]["dumps"] >= 1


def test_autoscale_battery_evidence(batteries):
    sc = batteries["autoscale"][1]["autoscale"]["scenarios"]
    assert sc["scale_up_burst"]["scaled_to"] == 2
    sick = sc["sick_model_fleet_rollback"]
    assert sick["fired"] and sick["fleet_rollbacks"] == 1
    assert sick["canary_failing_seen"] == 2
    assert set(sick["per_replica_digests"].values()) == {sick["digest_a"]}
    drain = sc["drain_down_idle"]
    assert drain["orphaned_session_expired_typed"] is True
    assert drain["survivor_session_ok"] is True
    death = sc["death_during_scale_up"]
    assert death["admitted"] and death["hung_futures"] == 0
    assert death["post_admit_builds"] == 0


def test_federation_battery_evidence(batteries):
    sc = batteries["federation"][1]["federation"]["scenarios"]
    assert {"federation.dispatch", "router.dispatch", "batch.device"} <= \
        set(sc["federation_trace_stitch"]["span_names"])
    for key in ("staged_rollout", "wave_canary_failure",
                "partition_mid_rollout"):
        assert sc[key]["torn_versions"] == []
    assert sc["wave_canary_failure"]["abort_wave"] == 0
    assert sc["partition_mid_rollout"]["abort_wave"] == 1
    assert sc["partition_mid_rollout"]["reconciled"] is True
    death = sc["member_death_pinned_sessions"]
    assert death["victim_session_expired_typed"] is True
    assert death["survivor_session_ok"] is True
