"""The port's placement layer (`dsin_tpu_torch/serve/placement.py`) against
the JAX package's `serve/placement.py`, on the CPU.

The planner and the rebalance trigger are pure: the port's plans, weights
and census over a grid of ladders (1-5 buckets), device counts (1-8) and
weights (uniform, skewed, zero) are the JAX package's EXACTLY, the two
triggers fed the same scripted windows (the JAX tests' scenarios) decide
the same thing at every check, and each typed refusal has the same class
name and message. The runtime half is the port's own: `put_batch` lands on
the named device, `replicate` copies the weights into storage of their own,
`set_plan` swaps atomically and validates, and a device count beyond what
is visible raises typed PlacementError (logical devices are named with a
tuple, a repeat allowed).
"""

import threading

import numpy as np
import pytest
import torch

from dsin_tpu.serve import placement as jax_placement
from dsin_tpu_torch.serve import placement as port_placement
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LADDERS = {1: ((16, 24),),
           2: ((16, 24), (32, 48)),
           3: ((16, 24), (32, 48), (64, 96)),
           4: ((16, 24), (32, 48), (64, 96), (128, 144)),
           5: ((16, 24), (32, 48), (64, 96), (128, 144), (160, 600))}


def _weights(ladder, kind):
    if kind == "uniform":
        return None
    if kind == "zero":
        return {b: 0.0 for b in ladder}
    # skewed: the first bucket hot, the rest falling off, one left unnamed
    named = ladder[:-1] if len(ladder) > 1 else ladder
    return {b: 10.0 / (i + 1) ** 2 for i, b in enumerate(named)}


@pytest.mark.parametrize("kind", ["uniform", "skewed", "zero"])
@pytest.mark.parametrize("n_buckets", sorted(LADDERS))
def test_plans_equal_the_jax_planner(n_buckets, kind):
    ladder = LADDERS[n_buckets]
    for num_devices in range(1, 9):
        w = _weights(ladder, kind)
        want = jax_placement.plan_placement(ladder, num_devices, w)
        got = port_placement.plan_placement(ladder, num_devices, w)
        assert got.num_devices == want.num_devices
        assert dict(got.assignments) == dict(want.assignments), (
            num_devices, got.as_dict(), want.as_dict())
        assert dict(got.weights) == dict(want.weights)
        assert got.census() == want.census()
        assert got.as_dict() == want.as_dict()
        for d in range(num_devices):
            assert got.buckets_for(d) == want.buckets_for(d)
        for b in ladder:
            assert got.devices_for(b) == want.devices_for(b)


A, B = (16, 24), (32, 48)

#: (trigger knobs, [(now, cumulative counts), ...]): the JAX package's
#: scripted windows (tests/test_serve_placement.py)
SCRIPTS = {
    "balanced": ({}, [(0.0, {A: 10, B: 10}), (10.0, {A: 20, B: 20})]),
    "hysteresis": ({}, [(0.0, {A: 20, B: 0}), (10.0, {A: 60, B: 0})]),
    "calm_resets": ({}, [(0.0, {A: 20, B: 0}), (10.0, {A: 30, B: 10}),
                         (20.0, {A: 50, B: 10}), (30.0, {A: 70, B: 10})]),
    "cooldown": ({"hysteresis_checks": 1, "cooldown_s": 50.0},
                 [(0.0, {A: 20, B: 0}), (10.0, {A: 40, B: 0}),
                  (40.0, {A: 60, B: 0}), (55.0, {A: 80, B: 0})]),
    "tiny_windows": ({"min_window_requests": 10},
                     [(0.0, {A: 20, B: 0}), (10.0, {A: 22, B: 0}),
                      (20.0, {A: 52, B: 0}), (30.0, {A: 82, B: 0})]),
    "cumulative": ({"hysteresis_checks": 1},
                   [(0.0, {A: 1000, B: 1000}), (10.0, {A: 1100, B: 1000})]),
}

#: what the JAX tests assert each script decides, check by check
EXPECTED = {
    "balanced": [None, None],
    "hysteresis": [None, {A: 41.0, B: 1.0}],
    "calm_resets": [None, None, None, "fire"],
    "cooldown": ["fire", None, None, "fire"],
    "tiny_windows": [None, None, None, "fire"],
    "cumulative": [None, {A: 101.0, B: 1.0}],
}


def _knobs(over):
    kw = dict(skew_threshold=1.5, hysteresis_checks=2, cooldown_s=100.0,
              min_window_requests=4)
    kw.update(over)
    return kw


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_trigger_decisions_equal_the_jax_trigger(script):
    over, checks = SCRIPTS[script]
    jt = jax_placement.RebalanceTrigger(**_knobs(over))
    pt = port_placement.RebalanceTrigger(**_knobs(over))
    for (now, counts), expect in zip(checks, EXPECTED[script]):
        want = jt.observe(now, counts)
        got = pt.observe(now, counts)
        assert got == want, (script, now)
        assert pt.last_skew == jt.last_skew
        if expect == "fire":
            assert got is not None
        else:
            assert got == expect


def _refusal(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return type(info.value).__name__, str(info.value)


LADDER = LADDERS[3]


@pytest.mark.parametrize("call", [
    lambda m: m.plan_placement([], 2),
    lambda m: m.plan_placement(LADDER, 0),
    lambda m: m.plan_placement(LADDER, -1),
    lambda m: m.plan_placement([(16, 24), (16, 24)], 2),
    lambda m: m.plan_placement(LADDER, 2, weights={(999, 999): 1.0}),
    lambda m: m.plan_placement(LADDER, 2, weights={(16, 24): -1.0}),
    lambda m: m.plan_placement(LADDER, 2).devices_for((640, 960)),
    lambda m: m.RebalanceTrigger(skew_threshold=0.5),
    lambda m: m.RebalanceTrigger(hysteresis_checks=0),
    lambda m: m.RebalanceTrigger(cooldown_s=-1),
    lambda m: m.RebalanceTrigger(min_window_requests=0)])
def test_refusals_equal_the_jax_package(call):
    want = _refusal(lambda: call(jax_placement))
    got = _refusal(lambda: call(port_placement))
    assert got == want == ("PlacementError", want[1])
    assert issubclass(port_placement.PlacementError, ValueError)


def test_put_batch_lands_on_the_named_device_and_replicas_own_storage():
    dp = port_placement.DevicePlacement([A, B], devices=("cpu", "cpu"))
    assert dp.num_devices == 2 and dp.plan.as_dict() == {"16x24": [0],
                                                         "32x48": [1]}
    x = np.arange(4 * 16 * 24 * 3, dtype=np.float32).reshape(4, 16, 24, 3)
    for d in range(2):
        t = dp.put_batch(d, x)
        assert t.device == dp.devices[d] == torch.device("cpu")
        np.testing.assert_array_equal(t.numpy(), x)
    model = torch.nn.Linear(3, 2)
    copies = [dp.replicate(d, model) for d in range(2)]
    for c in copies:
        for p, q in zip(c.parameters(), model.parameters()):
            assert p.data_ptr() != q.data_ptr()
            assert torch.equal(p, q)
    assert copies[0].weight.data_ptr() != copies[1].weight.data_ptr()


def test_more_devices_than_visible_raises_typed():
    cpu = torch.device("cpu")
    with pytest.raises(port_placement.PlacementError, match="tuple"):
        port_placement.serve_devices(2, cpu)
    with pytest.raises(port_placement.PlacementError, match=">= 1"):
        port_placement.serve_devices(0, cpu)
    with pytest.raises(port_placement.PlacementError, match="not visible"):
        port_placement.serve_devices(("cuda:7",), cpu)
    with pytest.raises(port_placement.PlacementError, match="tuple"):
        port_placement.serve_devices("cpu", cpu)
    assert port_placement.serve_devices(None, cpu) == (cpu,)
    assert port_placement.serve_devices(1, cpu) == (cpu,)
    assert port_placement.serve_devices(("cpu",) * 4, cpu) == (cpu,) * 4
    assert [port_placement.device_count(s)
            for s in (None, 1, 3, ("cpu",) * 4)] == [1, 1, 3, 4]


def test_set_plan_swaps_atomically_and_validates():
    dp = port_placement.DevicePlacement(LADDER, devices=("cpu",) * 2)
    old = dp.plan
    new = port_placement.plan_placement(
        LADDER, 2, weights=dict(zip(LADDER, (10.0, 1.0, 1.0))))
    assert dp.set_plan(new) == (new.assignments != old.assignments)
    assert dp.plan is new
    with pytest.raises(port_placement.PlacementError, match="spans 4"):
        dp.set_plan(port_placement.plan_placement(LADDER, 4))
    with pytest.raises(port_placement.PlacementError, match="ladder"):
        dp.set_plan(port_placement.plan_placement([(16, 24)], 2))
    assert dp.plan is new
    # readers racing a stream of swaps only ever see whole plans
    plans = [port_placement.plan_placement(
        LADDER, 2, weights=dict(zip(LADDER, w)))
        for w in ((10.0, 1.0, 1.0), (1.0, 10.0, 1.0), (1.0, 1.0, 10.0))]
    seen, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            seen.append(dp.plan)

    t = threading.Thread(target=reader)
    t.start()
    for i in range(300):
        dp.set_plan(plans[i % 3])
    stop.set()
    t.join()
    assert seen and all(p is new or p in plans for p in seen)
    assert all(set(p.assignments) == set(LADDER) for p in seen)
