"""The port's two-group optimizer (`train/optim.py`) against optax through
the JAX package's `build_optimizer`, on the same gradients: the parameter
tree of the tiny DSIN (`bridge.py` carries the weights, the gradients and
the moments between the layouts), three steps of seeded gradients.

Bounds: ADAM, SGD and MOMENTUM run optax's arithmetic in its order, in
float32, so the parameters and every moment are equal to optax's within 2
float32 ulps of the leaf's largest magnitude (XLA may contract a multiply
and an add into one rounding where torch rounds twice); the step counts and
the schedules are exact (float32 values at steps 0, d - 1, d and 2d);
frozen partitions are bit-unchanged.
"""

import copy

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dsin_tpu.config import parse_config as jax_parse_config
from dsin_tpu.train import optim as jax_optim
from dsin_tpu_torch import bridge
from dsin_tpu_torch.config import parse_config
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.train import optim as port_optim
from torch_train_parity import leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ULPS = 2 * np.finfo(np.float32).eps


def _configs(**over):
    ae, pc = tiny_configs(1)
    pc_over = {k[3:]: over.pop(k) for k in list(over) if k.startswith("pc_")}
    return ae.replace(**over), pc.replace(**pc_over)


def _run(ae, pc, steps=3, seed=0):
    """`steps` updates of both optimizers on the same seeded gradients;
    returns (port params, JAX params, port opt_state tree, JAX opt_state
    state dict, initial params)."""
    model = build_model(ae, pc, device="cpu", seed=1)
    optimizer = port_optim.Optimizer(model, ae, pc, num_training_imgs=10)
    params0, _ = bridge.jax_from_state_dict(model.state_dict())
    tx = jax_optim.build_optimizer(params0, jax_parse_config(str(ae)),
                                   jax_parse_config(str(pc)), 10)
    jparams = jax.tree_util.tree_map(jnp.asarray, params0)
    jstate = tx.init(jparams)

    @jax.jit
    def jax_update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    rng = np.random.default_rng(seed)
    for _ in range(steps):
        grads = {n: torch.from_numpy(rng.normal(
            0, 0.1, p.shape).astype(np.float32))
            for n, p in model.named_parameters()}
        optimizer.update(grads)
        jparams, jstate = jax_update(bridge.jax_params_tree(grads), jstate,
                                     jparams)
    got, _ = bridge.jax_from_state_dict(model.state_dict())
    return (got, jax.device_get(jparams), optimizer.state_tree(),
            jax.device_get(flax.serialization.to_state_dict(jstate)),
            params0, optimizer)


def _assert_trees_match(got, want, what):
    g, w = leaves(got), leaves(want)
    assert set(g) == set(w), (what, set(g) ^ set(w))
    for path, wv in w.items():
        gv = g[path]
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, (what, path)
        if path[-1] == "count":
            assert int(gv) == int(wv), (what, path)
            continue
        err = float(np.abs(gv - wv).max())
        assert err <= ULPS * float(np.abs(wv).max()) + 1e-30, (what, path,
                                                               err)


CASES = {
    "adam": {},
    "sgd": dict(optimizer="SGD", pc_optimizer="SGD"),
    "momentum": dict(optimizer="MOMENTUM", optimizer_momentum=0.9),
    "centers_factor": dict(lr_centers_factor=3.0),
    "frozen_pc": dict(train_probclass=False),
    "frozen_ae": dict(train_autoencoder=False, lr_centers_factor=0.5),
    "decay": dict(lr_schedule="DECAY", lr_schedule_decay_interval=1,
                  lr_schedule_decay_rate=0.5,
                  lr_schedule_decay_staircase=False, AE_only=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(case):
    ae, pc = _configs(**CASES[case])
    got, want, got_state, want_state, params0, optimizer = _run(ae, pc)
    _assert_trees_match(got, want, "params")
    _assert_trees_match(got_state, want_state, "opt_state")
    # the layout of the state, masked leaves and counts included
    assert jax.tree_util.tree_structure(got_state) == \
        jax.tree_util.tree_structure(want_state)
    frozen = [n for n, lab in optimizer.labels.items() if lab == "frozen"]
    moved = leaves(got)
    before = leaves(params0)
    for name in optimizer.names:
        path = tuple(bridge._jax_leaf(name)[0])
        unchanged = np.array_equal(moved[path], before[path])
        assert unchanged == (name in frozen), (name, unchanged)


def test_label_tree():
    ae, pc = tiny_configs(1)
    assert {p: port_optim.label_for(p, ae) for p in (
        "encoder", "decoder", "centers", "probclass", "sinet")} == {
        "encoder": "ae", "decoder": "ae", "centers": "ae",
        "probclass": "pc", "sinet": "ae"}
    centers = ae.replace(lr_centers_factor=2.0)
    assert port_optim.label_for("centers", centers) == "centers"
    frozen = centers.replace(train_autoencoder=False)
    # freezing the AE freezes the centers too, whatever their factor
    assert [port_optim.label_for(p, frozen) for p in (
        "encoder", "centers", "sinet")] == ["frozen", "frozen", "ae"]
    assert port_optim.label_for("probclass", ae.replace(
        train_probclass=False)) == "frozen"


@pytest.mark.parametrize("staircase", [True, False])
def test_schedules_are_optax_float32(staircase):
    cfg = parse_config(f"""
        lr_initial = 3e-4
        lr_schedule = 'DECAY'
        lr_schedule_decay_interval = 2
        lr_schedule_decay_rate = 0.7
        lr_schedule_decay_staircase = {staircase}
        """)
    port = port_optim.learning_rate_schedule(cfg, 1, 5, 1, ae_only=False)
    want = jax_optim.learning_rate_schedule(jax_parse_config(str(cfg)), 1, 5,
                                            1, ae_only=False)
    d = 5 * 2                     # iterations per epoch x the interval
    for count in (0, 1, d - 1, d, d + 3, 2 * d):
        got = np.float32(port(count))
        exp = np.float32(want(jnp.int32(count)))
        assert got == exp and got.dtype == exp.dtype, (count, got, exp)
    fixed = parse_config("lr_initial = 3e-4\nlr_schedule = 'FIXED'\n")
    assert port_optim.learning_rate_schedule(fixed, 1, 5, 1, False)(77) \
        == 3e-4
    with pytest.raises(ValueError, match="lr_schedule"):
        port_optim.learning_rate_schedule(fixed.replace(lr_schedule="COS"),
                                          1, 5, 1, False)


def test_iterations_per_epoch():
    assert port_optim.iterations_per_epoch(1, 1, 100, ae_only=False) == 100
    assert port_optim.iterations_per_epoch(1, 1, 100, ae_only=True) == 1281000
    assert port_optim.iterations_per_epoch(2, 4, 100, ae_only=False) == 50
    for args in ((1, 1, 100, False), (2, 4, 100, False), (1, 8, 3, True)):
        assert port_optim.iterations_per_epoch(*args) == \
            jax_optim.iterations_per_epoch(*args)


def test_state_tree_round_trips_and_refuses_a_foreign_tree():
    ae, pc = _configs()
    *_, optimizer = _run(ae, pc, steps=2)
    tree = optimizer.state_tree()
    model = build_model(ae, pc, device="cpu", seed=5)
    other = port_optim.Optimizer(model, ae, pc, 10)
    other.load_state_tree(tree)
    _assert_trees_match(other.state_tree(), tree, "round trip")
    assert other.groups["ae"].count == 2
    bad = copy.deepcopy(tree)
    bad["inner_states"]["ae"]["inner_state"]["1"]["count"] = np.asarray(
        3, np.int32)
    with pytest.raises(ValueError, match="step counts"):
        other.load_state_tree(bad)
