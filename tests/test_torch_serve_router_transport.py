"""The serve bench's transport leg, its router half
(`serve_bench.run_router_transport`, the JAX leg's `_run_transport_section`
router runs and `_gate_transport`'s router checks) on the CPU: one spawned
replica (thread backend) per transport, "pipe" then "shm", at the tiny
configuration of tests/test_train_step.py with one (128, 144) bucket, whose
payloads are above the lanes' inline threshold. The probes' streams are
byte-identical across transports, the shm run sent lanes with no
integrity error, nothing failed, the replicas built nothing after their
ready handshake and launched no kernel; the gate passes and flags each
tampered section. Exact.
"""

import argparse
import copy

import pytest

from dsin_tpu_torch.tools import serve_bench
from test_train_step import tiny_ae_cfg, tiny_pc_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def leg(tmp_path_factory):
    root = tmp_path_factory.mktemp("router_transport")
    ae_p, pc_p = str(root / "ae"), str(root / "pc")
    with open(ae_p, "w") as f:
        f.write(str(tiny_ae_cfg(crop_size=(16, 24), batch_size=1)))
    with open(pc_p, "w") as f:
        f.write(str(tiny_pc_cfg()))
    args = argparse.Namespace(
        ae_config=ae_p, pc_config=pc_p, seed=0, buckets="128,144",
        shapes="128,144 120,130", requests=6, rate=1000.0,
        decode_samples=2, max_wait_ms=50.0, entropy_workers=1,
        device="cpu")
    return serve_bench.run_router_transport(args)


def test_streams_are_byte_identical_and_the_lanes_ran(leg):
    assert leg["bit_identical"] is True
    assert set(leg["runs"]) == {"pipe", "shm"}
    for run in leg["runs"].values():
        assert run["completed"] == 6 and run["failed"] == 0
        assert run["shed_at_door"] == 0 and run["decode_roundtrips"] == 2
        assert run["shm"]["integrity_errors"] == 0
        assert set(run["replica_builds_after_ready"].values()) == {0}
        for counts in run["replica_kernel_launches"].values():
            assert counts and set(counts.values()) == {0}
    assert leg["runs"]["shm"]["shm"]["sends"] > 0
    assert leg["runs"]["pipe"]["shm"]["sends"] == 0
    assert isinstance(leg["shm_vs_pipe"], float)
    assert isinstance(leg["runs"]["shm"]["effective_cores"], float)


def test_the_gate_passes(leg):
    assert serve_bench.gate_router_transport(leg) == []


@pytest.mark.parametrize("tamper,match", [
    (lambda t: t.update(bit_identical=False), "different bytes"),
    (lambda t: t["runs"]["shm"]["shm"].update(sends=0), "zero lane sends"),
    (lambda t: t["runs"]["pipe"]["shm"].update(integrity_errors=1),
     "integrity"),
    (lambda t: t["runs"]["shm"].update(failed=1), "untyped/hung"),
    (lambda t: (t.update(shm_vs_pipe=0.3),
                t["runs"]["shm"].update(effective_cores=1.9)),
     "broken-transport floor")])
def test_the_gate_flags_a_tampered_section(leg, tamper, match):
    section = copy.deepcopy(leg)
    tamper(section)
    violations = serve_bench.gate_router_transport(section)
    assert violations and any(match in v for v in violations), violations


def test_a_serial_window_notes_the_floor_instead(leg, capsys):
    section = copy.deepcopy(leg)
    section["shm_vs_pipe"] = 0.3
    section["runs"]["shm"]["effective_cores"] = 1.0
    assert serve_bench.gate_router_transport(section) == []
    assert "transport floor not applied" in capsys.readouterr().err
