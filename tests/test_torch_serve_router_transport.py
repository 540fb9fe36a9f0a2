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
import time
from concurrent.futures import Future
from types import SimpleNamespace

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
    for run in leg["runs"].values():
        assert isinstance(run["effective_cores"], float)
        assert isinstance(run["effective_cores_after"], float)


def test_the_gate_passes(leg):
    assert serve_bench.gate_router_transport(leg) == []


@pytest.mark.parametrize("tamper,match", [
    (lambda t: t.update(bit_identical=False), "different bytes"),
    (lambda t: t["runs"]["shm"]["shm"].update(sends=0), "zero lane sends"),
    (lambda t: t["runs"]["pipe"]["shm"].update(integrity_errors=1),
     "integrity"),
    (lambda t: t["runs"]["shm"].update(failed=1), "untyped/hung"),
    (lambda t: (t.update(shm_vs_pipe=0.3),
                [r.update(effective_cores=1.9, effective_cores_after=1.9)
                 for r in t["runs"].values()]),
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


class _FakeRouter:
    """A door that answers every encode at once, `delay_s` late (a run
    slowed by a load on the host), with a fixed stream."""

    def __init__(self, delay_s):
        self.delay_s = delay_s
        self.metrics = SimpleNamespace(
            snapshot=lambda: {"counters": {"serve_shm_sends": 1}})

    def submit_encode(self, img):
        time.sleep(self.delay_s)
        fut = Future()
        fut.set_result(SimpleNamespace(stream=b"s"))
        return fut

    def encode(self, img, timeout=None):
        return SimpleNamespace(stream=b"s")

    def decode(self, stream, timeout=None):
        return stream

    def drain(self, timeout_s=None):
        return True


def test_a_load_that_arrives_during_a_run_notes_the_floor(monkeypatch,
                                                           capsys):
    """The fault behind a red run under `-n 6`: the shm run was slowed by
    a load that arrived after the one probe taken before it (parallel
    headroom, 1.37), and the gate held shm at 0.441x pipe against the
    floor. Each run now probes before and after, and a pair with a probe
    under 1.3 around either run is a serial window: a note, not a
    violation. Here the host reads 1.9 around the pipe run and before the
    shm run, and 1.0 once the (slowed) shm stream resolved."""
    probes = iter([1.9, 1.9, 1.9, 1.0])
    monkeypatch.setattr(serve_bench, "_effective_cores",
                        lambda: next(probes))
    monkeypatch.setattr(serve_bench, "replica_counts", lambda router: {
        "builds_after_ready": {"0": 0}, "kernel_launches": {"0": {}}})
    args = argparse.Namespace(requests=8, rate=1000.0, decode_samples=2)
    routers = {"pipe": lambda: _FakeRouter(0.0),
               "shm": lambda: _FakeRouter(0.05)}
    section = serve_bench.run_router_transport(
        args, images=[None], probes=[None], routers=routers)
    assert section["shm_vs_pipe"] < 0.5
    assert serve_bench.gate_router_transport(section) == []
    assert "transport floor not applied" in capsys.readouterr().err
    assert section["runs"]["shm"]["effective_cores"] == 1.9
    assert section["runs"]["shm"]["effective_cores_after"] == 1.0
