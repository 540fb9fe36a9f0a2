"""The port's checkpoint writer visits the JAX package's fault sites.

`ckpt.write` is visited on each attempt of each staged file write, inside
the bounded retry, and `ckpt.swap` between the two renames of a save, in
`dsin_tpu_torch/train/checkpoint.py` as in `dsin_tpu/train/checkpoint.py`.
One tiny training state (the JAX durability test's five partitions and its
optax state) is saved by both packages; the same `FaultPlan`, installed in
each package's own `utils/faults`, kills both saves at the same point, and
both must leave the same resolvable state: the same files, a `.prev-*`
that `latest_checkpoint` resolves after a kill between the renames, and
the previous checkpoint restorable after a kill at any write, with
parameters equal in both packages (exact: the same bytes are restored).
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsin_tpu.config import parse_config as jax_parse_config
from dsin_tpu.train import checkpoint as jax_ckpt
from dsin_tpu.train import optim as jax_optim
from dsin_tpu.train.step import TrainState
from dsin_tpu.utils import faults as jax_faults
from dsin_tpu_torch.train import checkpoint as port_ckpt
from dsin_tpu_torch.utils import faults as port_faults
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PARTS = list(port_ckpt.AE_PARTITIONS) + ["sinet"]
#: staged writes of one save: 5 partitions, batch_stats, opt_state,
#: manifest, meta
WRITES_PER_SAVE = 9


@pytest.fixture(autouse=True)
def _no_leftover_plans():
    jax_faults.uninstall()
    port_faults.uninstall()
    yield
    jax_faults.uninstall()
    port_faults.uninstall()


def _states(step, seed=0):
    """(JAX TrainState, port ModelState) of the same trees."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    params = {
        "encoder": {"conv": {"kernel": jax.random.normal(ks[0], (3,))}},
        "decoder": {"conv": {"kernel": jax.random.normal(ks[1], (3,))}},
        "centers": jax.random.normal(ks[2], (6,)),
        "probclass": {"conv": {"kernel": jax.random.normal(ks[3], (3,))}},
        "sinet": {"conv": {"kernel": jax.random.normal(ks[4], (3,))}},
    }
    ae = jax_parse_config(
        "batch_size = 1\nnum_crops_per_img = 1\nAE_only = False\n"
        "optimizer = 'ADAM'\nlr_initial = 0.1\nlr_schedule = 'FIXED'\n"
        "train_autoencoder = True\ntrain_probclass = True\n"
        "lr_centers_factor = None\n")
    pc = jax_parse_config(
        "optimizer = 'ADAM'\nlr_initial = 0.001\nlr_schedule = 'FIXED'\n")
    tx = jax_optim.build_optimizer(params, ae, pc, num_training_imgs=10)
    batch_stats = {"encoder": {}, "decoder": {}}
    jstate = TrainState(params=params, batch_stats=batch_stats,
                        opt_state=tx.init(params),
                        step=jnp.asarray(step, jnp.int32))
    # the JAX tree's key order (tree_map would sort the top level)
    host = {k: jax.tree_util.tree_map(np.asarray, v)
            for k, v in params.items()}
    pstate = port_ckpt.ModelState(
        host, batch_stats, step,
        jax.tree_util.tree_map(np.asarray, flax.serialization.to_state_dict(
            jstate.opt_state)))
    return jstate, pstate


def _both(tmp_path, step=7, seed=0, **kwargs):
    """Save the state of `step` in both packages; -> the two dirs."""
    jstate, pstate = _states(step, seed)
    jdir = str(tmp_path / "jax" / "ckpt")
    pdir = str(tmp_path / "port" / "ckpt")
    jax_ckpt.save_checkpoint(jdir, jstate, **kwargs)
    port_ckpt.save_checkpoint(pdir, pstate, **kwargs)
    return jdir, pdir


def _crash_both(jdir, pdir, spec, step=8, seed=1):
    """The same plan kills a save of `step` in each package; -> the two
    plans."""
    jstate, pstate = _states(step, seed)
    plans = []
    for faults, save, d, state in (
            (jax_faults, jax_ckpt.save_checkpoint, jdir, jstate),
            (port_faults, port_ckpt.save_checkpoint, pdir, pstate)):
        plan = faults.FaultPlan([faults.FaultSpec(**spec)], seed=0)
        with faults.installed(plan):
            with pytest.raises(faults.InjectedFault):
                save(d, state)
        plans.append(plan)
    return plans


def _restored_params(ckpt_dir):
    """The partitions each package restores from `ckpt_dir`, as numpy."""
    jtemplate, ptemplate = _states(0, seed=9)
    jgot = jax_ckpt.restore_partitions(ckpt_dir, jtemplate, PARTS,
                                       load_opt_state=True)
    pgot = port_ckpt.restore_partitions(ckpt_dir, ptemplate, PARTS,
                                        load_opt_state=True)
    assert int(jgot.step) == pgot.step
    return (jax.tree_util.tree_map(np.asarray, jgot.params), pgot.params,
            pgot.step)


def _assert_trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _listing(d):
    return sorted(os.listdir(d))


def test_a_save_visits_the_sites_as_often_in_both(tmp_path):
    jdir, pdir = _both(tmp_path)
    jstate, pstate = _states(8, 1)
    plans = []
    for faults, save, d, state in (
            (jax_faults, jax_ckpt.save_checkpoint, jdir, jstate),
            (port_faults, port_ckpt.save_checkpoint, pdir, pstate)):
        with faults.installed(faults.FaultPlan([])) as plan:
            save(d, state)
        plans.append(plan)
    jplan, pplan = plans
    assert pplan.visits == jplan.visits
    assert pplan.visits["ckpt.write"] == WRITES_PER_SAVE
    assert pplan.visits["ckpt.swap"] == 1
    # the files of both saves are the same bytes
    for fname in _listing(jdir):
        with open(os.path.join(jdir, fname), "rb") as a, \
                open(os.path.join(pdir, fname), "rb") as b:
            assert a.read() == b.read(), fname


def test_a_transient_write_error_is_retried_in_both(tmp_path):
    jdir, pdir = _both(tmp_path)
    jstate, pstate = _states(8, 1)
    for faults, save, d, state in (
            (jax_faults, jax_ckpt.save_checkpoint, jdir, jstate),
            (port_faults, port_ckpt.save_checkpoint, pdir, pstate)):
        plan = faults.FaultPlan([faults.FaultSpec(
            site="ckpt.write", after=2, times=1,
            exc=lambda: OSError("transient EIO"))], seed=0)
        with faults.installed(plan):
            save(d, state)
        # one failed attempt, retried: one visit more than a clean save
        assert plan.visits["ckpt.write"] == WRITES_PER_SAVE + 1
        assert plan.activations["ckpt.write"] == 1
        assert port_ckpt.load_meta(d)["step"] == 8


def test_a_kill_between_the_renames_leaves_the_same_prev(tmp_path):
    jdir, pdir = _both(tmp_path, best_val=1.5)
    jplan, pplan = _crash_both(jdir, pdir, dict(site="ckpt.swap"))
    assert jplan.activations["ckpt.swap"] == \
        pplan.activations["ckpt.swap"] == 1
    assert not os.path.exists(jdir) and not os.path.exists(pdir)
    assert _listing(os.path.dirname(jdir)) == \
        _listing(os.path.dirname(pdir)) == ["ckpt.prev-000001",
                                           "ckpt.tmp-%d" % os.getpid()]
    # each package resolves the rotated copy, in its own tree and the other's
    for d in (jdir, pdir):
        resolved = port_ckpt.latest_checkpoint(d)
        assert resolved == jax_ckpt.latest_checkpoint(d) == d + ".prev-000001"
        jparams, pparams, step = _restored_params(resolved)
        assert step == 7 and port_ckpt.load_meta(resolved)["best_val"] == 1.5
        _assert_trees_equal(jparams, pparams)
        _assert_trees_equal(pparams, _states(7)[1].params)
    # the next save sweeps the stale staging dir and takes the live name
    jstate, pstate = _states(9, 2)
    jax_ckpt.save_checkpoint(jdir, jstate)
    port_ckpt.save_checkpoint(pdir, pstate)
    assert _listing(os.path.dirname(jdir)) == \
        _listing(os.path.dirname(pdir)) == ["ckpt", "ckpt.prev-000001"]
    assert port_ckpt.latest_checkpoint(pdir) == pdir


@pytest.mark.parametrize("visit", range(WRITES_PER_SAVE))
def test_a_kill_at_each_write_leaves_the_previous_checkpoint(tmp_path, visit):
    """As tests/test_checkpoint_durability.py's staging-kill test, visit by
    visit, on both packages: the live checkpoint stays restorable with its
    manifest, and the two packages' trees agree."""
    jdir, pdir = _both(tmp_path, best_val=1.5)
    jplan, pplan = _crash_both(
        jdir, pdir, dict(site="ckpt.write", after=visit, times=None))
    assert jplan.visits["ckpt.write"] == pplan.visits["ckpt.write"] \
        == visit + 1
    for d in (jdir, pdir):
        assert port_ckpt.latest_checkpoint(d) == os.path.abspath(d)
        assert jax_ckpt.latest_checkpoint(d) == os.path.abspath(d)
        assert port_ckpt.load_meta(d)["best_val"] == 1.5
        manifest = port_ckpt.load_manifest(d)
        assert manifest["step"] == 7
        port_ckpt.verify_files(d, manifest)
        jparams, pparams, step = _restored_params(d)
        assert step == 7
        _assert_trees_equal(jparams, pparams)
        _assert_trees_equal(pparams, _states(7)[1].params)
    # with the plan gone, the same save goes through in both
    jstate, pstate = _states(8, 1)
    jax_ckpt.save_checkpoint(jdir, jstate)
    port_ckpt.save_checkpoint(pdir, pstate)
    assert port_ckpt.load_manifest(jdir)["step"] == \
        port_ckpt.load_manifest(pdir)["step"] == 8
