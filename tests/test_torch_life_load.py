"""`chip_smoke.py` phase 11's load clients (`LifeLoad`) against a service
that fails every request at once, on the CPU.

A client that notes a failure and goes straight on to the next image spins
on such a service and records every error; with the wait for B' running
its full 600 s that is unbounded memory. The clients back off and stop
after `LIFE_ERRORS` failures, and the wait stops at the first failed
request and names it.
"""

import os
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)


class FailingService:
    """Answers every encode with the same error, at once."""

    def __init__(self):
        self.calls = 0

    def encode(self, img, timeout):
        self.calls += 1
        raise RuntimeError("no live worker")


def traffic(n: int = 6):
    imgs = [np.zeros((8, 8, 3), np.uint8) for _ in range(n)]
    return [None], imgs, [0] * n


def test_failing_clients_back_off_and_stop(monkeypatch):
    """Each client records at most LIFE_ERRORS failures and then stops on
    its own; between failures it waits, so the calls stay the records."""
    monkeypatch.setattr(chip_smoke, "LIFE_BACKOFF_S", (0.01, 0.04))
    svc = FailingService()
    load = chip_smoke.LifeLoad(svc, traffic()).start()
    deadline = time.monotonic() + 30.0
    while any(t.is_alive() for t in load.threads):
        assert time.monotonic() < deadline, "a failing client never stopped"
        time.sleep(0.01)
    records = load.finish()
    bound = chip_smoke.SERVE_CLIENTS * chip_smoke.LIFE_ERRORS
    assert len(records) == svc.calls == bound
    assert all(r[5] is not None and r[0] == "encode" for r in records)


def test_a_failing_client_waits_between_requests():
    """At the phase's own backoff a client makes at most a handful of
    requests in a second, where one without it made thousands."""
    svc = FailingService()
    load = chip_smoke.LifeLoad(svc, traffic()).start()
    time.sleep(1.0)
    records = load.finish()
    # 0.05 + 0.1 + 0.2 + 0.4 s of waits fit the second: 5 requests a client
    assert len(records) == svc.calls <= 5 * chip_smoke.SERVE_CLIENTS


def test_the_wait_stops_at_the_first_failure_and_names_it():
    svc = FailingService()
    load = chip_smoke.LifeLoad(svc, traffic()).start()
    t0 = time.monotonic()
    try:
        with pytest.raises(AssertionError,
                           match=r"waiting for an encode answered by B': "
                                 r"encode of image \d: RuntimeError\('no live "
                                 r"worker'\)"):
            chip_smoke.wait_for(lambda: False, chip_smoke.SERVE_TIMEOUT_S,
                                "an encode answered by B'",
                                failed=load.first_error)
    finally:
        load.finish()
    assert time.monotonic() - t0 < 10.0


def test_the_wait_without_a_failure_still_times_out():
    with pytest.raises(AssertionError, match="did not happen within 0.05 s"):
        chip_smoke.wait_for(lambda: False, 0.05, "nothing",
                            failed=lambda: None)
