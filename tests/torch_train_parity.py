"""Shared by the port's training parity tests: seeded stereo batches, tree
comparisons with the bounds `tests/test_torch_train_step.py` states, and
one train step of each package from the same weights."""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dsin_tpu.config import parse_config as jax_parse_config
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu.ops.sifinder import gaussian_position_mask
from dsin_tpu.train import optim as jax_optim
from dsin_tpu.train import step as jax_step
from dsin_tpu_torch import bridge
from dsin_tpu_torch.data.synthetic import make_stereo_pair
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.train import step as port_step
from dsin_tpu_torch.train.optim import Optimizer

H, W, PH, PW = 40, 48, 20, 24
LR = 1e-4                      # tiny_configs' lr_initial, both groups
GRAD_RTOL = 5e-5               # of each leaf's largest magnitude
STATS_RTOL = 1e-5
PARAM_ATOL = 1e-6
KINK_SHARE = 0.03              # of the gradient leaves
KINK_REL_L2 = 0.25
GLOBAL_REL_L2 = 1e-2


def stereo_batch(seed: int, n: int):
    """n seeded stereo-like pairs: x the left view, y the right view
    shifted by 8 columns."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for _ in range(n):
        left, right = make_stereo_pair(rng, H, W + 8)
        xs.append(left[:, :W])
        ys.append(right[:, 8:])
    return (np.stack(xs).astype(np.float32), np.stack(ys).astype(np.float32))


def leaves(tree, prefix=()):
    """{path: array} of a nested dict's array leaves (empty maps skipped)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(leaves(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(value)
    return out


def assert_leaves_close(got, want, rtol, what, kinks=frozenset()):
    """Same structure; every leaf within rtol of its largest magnitude,
    except the paths in `kinks` (see `assert_grads_close`), held to
    KINK_REL_L2 instead."""
    got, want = leaves(got), leaves(want)
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path)
        if path in kinks:
            assert np.linalg.norm(g - w) <= KINK_REL_L2 * np.linalg.norm(w), (
                what, path)
            continue
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale + 1e-30, (what, path, err, scale)


def assert_grads_close(got, want, what="grads"):
    """The gradient bound: every leaf within GRAD_RTOL of its largest
    magnitude, except where a ReLU meets an input of exactly 0 in one
    package and of an ulp either side of it in the other: it passes the
    gradient at that position in one and not in the other, and moves the
    gradient of the leaves fed from there by one upstream term (seen: one
    exact zero in the first layer moved its kernel's gradient by 15%).
    Such leaves, at most KINK_SHARE of them, are held to KINK_REL_L2 in
    relative L2 and all leaves together to GLOBAL_REL_L2. Returns the set
    of those paths."""
    g_leaves, w_leaves = leaves(got), leaves(want)
    assert set(g_leaves) == set(w_leaves), (what, set(g_leaves) ^ set(
        w_leaves))
    kinks = set()
    for path, w in w_leaves.items():
        err = float(np.abs(g_leaves[path] - w).max())
        if err > GRAD_RTOL * float(np.abs(w).max()):
            kinks.add(path)
    assert len(kinks) <= KINK_SHARE * len(w_leaves), (what, sorted(kinks))
    flat_g = np.concatenate([g_leaves[p].ravel() for p in sorted(w_leaves)])
    flat_w = np.concatenate([w_leaves[p].ravel() for p in sorted(w_leaves)])
    assert np.linalg.norm(flat_g - flat_w) <= \
        GLOBAL_REL_L2 * np.linalg.norm(flat_w), what
    assert_leaves_close(got, want, GRAD_RTOL, what, kinks)
    return kinks


def assert_params_after_adam(new_port, new_jax, old, grads_jax, lr, what,
                             kinks=frozenset()):
    """The parameter bound of the module docstring: within PARAM_ATOL,
    except where the JAX gradient is within 2 * GRAD_RTOL of its leaf's
    largest magnitude of zero, and in the leaves `assert_grads_close`
    found at a ReLU's kink, where the first Adam step may differ by up to
    2 * lr (+ PARAM_ATOL for the rounding of each sum)."""
    new_port, new_jax = leaves(new_port), leaves(new_jax)
    old, grads_jax = leaves(old), leaves(grads_jax)
    assert set(new_port) == set(new_jax)
    banded = 0
    for path, want in new_jax.items():
        got = new_port[path]
        g = grads_jax[path]
        near_zero = np.abs(g) <= 2 * GRAD_RTOL * float(np.abs(g).max())
        if path in kinks:
            near_zero = np.ones_like(near_zero)
        diff = np.abs(got - want)
        assert float(diff[~near_zero].max(initial=0.0)) <= PARAM_ATOL, (
            what, path, float(diff[~near_zero].max(initial=0.0)))
        assert float(diff.max()) <= 2 * lr + PARAM_ATOL, (what, path)
        if path not in kinks:
            banded += int((diff[near_zero] > PARAM_ATOL).sum())
        # something moved: the step is not a no-op on this leaf
        assert not np.array_equal(want, old[path]) or not g.any(), path
    return banded


def grads_from_first_moment(opt_state) -> dict:
    """The gradient of a first Adam step, read from its first moment
    (mu = 0.1 * g, so g = mu / 0.1 within an ulp), in the params layout:
    the gradient `build_train_step_fn` applied, accumulated or not. Every
    group must train (a frozen group keeps no moment)."""
    flat = {}
    for label, group in opt_state["inner_states"].items():
        if label != "frozen":
            flat.update({k: v / np.float32(0.1) for k, v in leaves(
                group["inner_state"]["0"]["mu"]).items()})
    nested = {}
    for path, value in flat.items():
        node = nested
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = value
    return nested


def run_both(ae, pc, x, y, seed=3, grad_accum=1):
    """One step of each package from the port's seeded weights: returns
    dicts with the step's metrics, grads (JAX layout; JAX's read from its
    first moment), new params, batch stats and opt_state trees, and the
    forward's y_syn and symbols."""
    model = build_model(ae, pc, device="cpu", seed=seed)
    params, stats = bridge.jax_from_state_dict(model.state_dict())
    jm = JaxDSIN(jax_parse_config(str(ae)), jax_parse_config(str(pc)))
    tx = jax_optim.build_optimizer(params, jm.ae_config, jm.pc_config, 10)
    state = jax_step.TrainState(params=params, batch_stats=stats,
                                opt_state=tx.init(params), step=jnp.int32(0))
    mask = gaussian_position_mask(H, W, PH, PW)
    jmask = jnp.asarray(mask)
    train_step = jax_step.build_train_step_fn(jm, tx, si_mask=jmask,
                                              grad_accum=grad_accum)

    def jax_fn(state, x, y):
        _, aux = jax_step._forward_losses(jm, state.params,
                                          state.batch_stats, x, y, jmask,
                                          True, False)
        new, metrics = train_step(state, x, y)
        return aux["y_syn"], aux["symbols"], new, metrics

    y_syn, symbols, new, metrics = jax.device_get(
        jax.jit(jax_fn)(state, jnp.asarray(x), jnp.asarray(y)))
    opt_state = flax.serialization.to_state_dict(new.opt_state)
    want = dict(metrics={k: float(v) for k, v in metrics.items()},
                grads=grads_from_first_moment(opt_state), y_syn=y_syn,
                symbols=symbols, params=new.params,
                batch_stats=new.batch_stats, opt_state=opt_state,
                step=int(new.step), old=params)

    optimizer = Optimizer(model, ae, pc, 10)
    with torch.no_grad():
        _, aux = port_step.forward_losses(
            model, torch.from_numpy(x), torch.from_numpy(y),
            port_step._checked(model, mask), train=True)
    step = port_step.make_train_step(model, optimizer, si_mask=mask,
                                     grad_accum=grad_accum)
    state_out, metrics = step(x, y)
    new_params, new_stats = bridge.jax_from_state_dict(model.state_dict())
    got = dict(metrics={k: float(v) for k, v in metrics.items()},
               grads=bridge.jax_params_tree(
                   {n: p.grad for n, p in model.named_parameters()}),
               y_syn=None if aux["y_syn"] is None else aux["y_syn"].numpy(),
               symbols=aux["symbols"].numpy(), params=new_params,
               batch_stats=new_stats, opt_state=optimizer.state_tree(),
               step=state_out.step)
    return got, want
