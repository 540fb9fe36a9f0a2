"""Training across the packages: a 5-step SI trajectory in both from one
state and one batch sequence, and training checkpoints (`opt_state`) that
resume in the other package, at the tiny configuration
(`tests/torch_train_parity.py`).

Sequence, one JAX step function throughout: both packages take steps 1-2
from the port's seeded weights; the JAX state after step 2 is saved by the
JAX package and resumed in a fresh port model (`load_train_step`), which
takes step 3 beside JAX's own step 3; the port's state after step 3 is saved
by the port and restored by the JAX package's `restore_for_mode(
load_train_step=True)`, and both take steps 4-5.

Bounds: a restored state is bit-equal to the saved one (the same bytes);
`opt_state.msgpack` written by either package from the same trees is
byte-equal; a step from a restored state matches the other package's step
from the same state as a first step does (tests/test_torch_train_step.py:
the loss within rtol 1e-5, the gradient as read from the moments within its
bound); after Adam's first step, whose sign-like update turns rounding at
g ~ 0 into 2 * lr, the trajectories part by up to that much on a sliver of
the elements, so the losses of steps 2-5 agree within rtol 1e-3 (measured:
4e-7) and both fall over the five steps.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsin_tpu.config import parse_config as jax_parse_config
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu.ops.sifinder import gaussian_position_mask
from dsin_tpu.train import checkpoint as jax_ckpt
from dsin_tpu.train import optim as jax_optim
from dsin_tpu.train import step as jax_step
from dsin_tpu_torch import bridge
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.train import checkpoint as port_ckpt
from dsin_tpu_torch.train import step as port_step
from dsin_tpu_torch.train.optim import Optimizer
from torch_train_parity import H, PH, PW, W, leaves, stereo_batch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS = 5


def _port(ae, pc, seed):
    model = build_model(ae, pc, device="cpu", seed=seed)
    optimizer = Optimizer(model, ae, pc, 10)
    mask = gaussian_position_mask(H, W, PH, PW)
    return model, optimizer, port_step.make_train_step(model, optimizer,
                                                       si_mask=mask)


def _port_trees(model, optimizer):
    return port_ckpt.state_from_model(model, optimizer=optimizer)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_ckpt")
    ae, pc = tiny_configs(1)
    batches = [stereo_batch(40 + i, 1) for i in range(STEPS)]
    model, optimizer, step = _port(ae, pc, seed=3)
    params, stats = bridge.jax_from_state_dict(model.state_dict())
    jae, jpc = jax_parse_config(str(ae)), jax_parse_config(str(pc))
    jm = JaxDSIN(jae, jpc)
    tx = jax_optim.build_optimizer(params, jae, jpc, 10)
    jstate = jax_step.TrainState(params=params, batch_stats=stats,
                                 opt_state=tx.init(params),
                                 step=jnp.int32(0))
    jstep = jax.jit(jax_step.build_train_step_fn(
        jm, tx, si_mask=jnp.asarray(gaussian_position_mask(H, W, PH, PW))))
    out = {"port_loss": [], "jax_loss": []}

    def both(i):
        nonlocal jstate
        _, m = step(*batches[i])
        jstate, jm_ = jstep(jstate, *map(jnp.asarray, batches[i]))
        out["port_loss"].append(float(m["loss"]))
        out["jax_loss"].append(float(jm_["loss"]))

    both(0)
    both(1)
    # the JAX state after step 2, saved by the JAX package, resumes in a
    # fresh port model
    jdir = str(root / "weights" / "from_jax")
    jax_ckpt.save_checkpoint(jdir, jstate, best_val=1.5)
    cfg = ae.replace(load_model=True, load_train_step=True)
    model, optimizer, step = _port(ae, pc, seed=9)
    state = port_ckpt.restore_for_mode(jdir, _port_trees(model, optimizer),
                                       cfg)
    port_ckpt.load_state(model, state, optimizer)
    out["resumed_in_port"] = (_port_trees(model, optimizer),
                              jax.device_get(jstate))
    # the port re-saves it: its opt_state.msgpack is flax's bytes
    pdir = str(root / "weights" / "port_resave")
    port_ckpt.save_checkpoint(pdir, _port_trees(model, optimizer))
    out["msgpack_pairs"] = [(os.path.join(jdir, "opt_state.msgpack"),
                             os.path.join(pdir, "opt_state.msgpack"))]
    both(2)
    out["after_resume"] = (_port_trees(model, optimizer),
                           jax.device_get(jstate))
    # the port's state after step 3, saved by the port, restores in JAX
    pdir3 = str(root / "weights" / "from_port")
    port_ckpt.save_checkpoint(pdir3, _port_trees(model, optimizer),
                              best_val=1.25)
    template = jax_step.TrainState(params=params, batch_stats=stats,
                                   opt_state=tx.init(params),
                                   step=jnp.int32(0))
    jstate = jax_ckpt.restore_for_mode(pdir3, template, jae.replace(
        load_model=True, load_train_step=True, train_model=True))
    out["resumed_in_jax"] = (_port_trees(model, optimizer),
                             jax.device_get(jstate))
    jdir3 = str(root / "weights" / "jax_resave")
    jax_ckpt.save_checkpoint(jdir3, jstate)
    out["msgpack_pairs"].append((os.path.join(pdir3, "opt_state.msgpack"),
                                 os.path.join(jdir3, "opt_state.msgpack")))
    both(3)
    both(4)
    out["end"] = (_port_trees(model, optimizer), jax.device_get(jstate))
    return out


def _state_equal(port_state, jstate):
    """A port ModelState bit-equal to a (host) JAX TrainState."""
    want = {"params": jstate.params, "batch_stats": jstate.batch_stats,
            "opt_state": flax.serialization.to_state_dict(jstate.opt_state)}
    got = {"params": port_state.params, "batch_stats": port_state.batch_stats,
           "opt_state": port_state.opt_state}
    g, w = leaves(got), leaves(want)
    assert set(g) == set(w), set(g) ^ set(w)
    for path, value in w.items():
        assert g[path].dtype == value.dtype, path
        assert np.array_equal(g[path], value), path
    assert port_state.step == int(jstate.step)


def test_a_jax_training_checkpoint_resumes_in_the_port(run):
    _state_equal(*run["resumed_in_port"])
    assert run["resumed_in_port"][0].step == 2


def test_a_port_training_checkpoint_resumes_in_jax(run):
    _state_equal(*run["resumed_in_jax"])
    assert run["resumed_in_jax"][0].step == 3


def test_opt_state_msgpack_is_byte_equal_across_the_packages(run):
    for a, b in run["msgpack_pairs"]:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), (a, b)


def test_the_step_after_a_resume_matches(run):
    port_state, jstate = run["after_resume"]
    np.testing.assert_allclose(run["port_loss"][2], run["jax_loss"][2],
                               rtol=1e-5)
    assert port_state.step == int(jstate.step) == 3
    # the counts of every group
    counts = {p: int(v) for p, v in leaves(port_state.opt_state).items()
              if p[-1] == "count"}
    assert set(counts.values()) == {3}


def test_five_step_trajectories_agree_and_fall(run):
    port, jax_ = np.array(run["port_loss"]), np.array(run["jax_loss"])
    np.testing.assert_allclose(port[0], jax_[0], rtol=1e-5)
    np.testing.assert_allclose(port, jax_, rtol=1e-3)
    assert port[-1] < port[0] and jax_[-1] < jax_[0]
    port_state, jstate = run["end"]
    assert port_state.step == int(jstate.step) == STEPS
