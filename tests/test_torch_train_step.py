"""The port's train step against the JAX package's, at the tiny
configuration (`entry.tiny_configs`: 40x48 crops, 20x24 patches, B = 2,
remat on) from the same weights (`bridge.py`) and the same seeded batches.

Bounds, each stated where it is asserted:
  * batch norm in train mode (one ConvBN, one residual block): outputs
    within 1e-5 relative to their largest magnitude, the new running
    statistics within 1e-6, the batch statistics within 16 float32 ulps of
    the means they come from (float32 means in another summation order);
    frozen statistics and remat exact;
  * one train step in float32: the search's y_syn and the symbols exact;
    the loss and every metric within rtol 1e-5; every gradient leaf within
    5e-5 of its largest magnitude (float32 through some forty layers and
    their backward, summed in another order: 7.5e-6 seen), but for a leaf
    fed from a ReLU whose input is exactly 0 in one package and an ulp off
    it in the other (`torch_train_parity.assert_grads_close`: at most 3% of
    the leaves, 25% relative L2, 1% over all leaves); the new batch
    statistics within 1e-5 of their largest magnitude; the moments within
    the gradients' bound (mu = 0.1 g, nu = 0.001 g**2, so nu twice it); the
    step counts exact;
  * the new parameters within 1e-6, except where the JAX gradient lies
    within twice the gradient bound of zero: Adam's first step moves an
    element by lr * g / (|g| + 1e-8), so a rounding difference that flips
    or shrinks such a g to ~1e-8 moves the element by up to 2 * lr; those
    elements are held to 2 * lr + 1e-6 instead.
The bfloat16 step has its own bounds, in its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen.normalization import _compute_stats

from dsin_tpu.models import autoencoder as jax_ae
from dsin_tpu.ops.sifinder import gaussian_position_mask
from dsin_tpu_torch import bridge
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models import autoencoder as port_ae
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.train import step as port_step
from dsin_tpu_torch.train.optim import Optimizer
from torch_train_parity import (GRAD_RTOL, H, KINK_REL_L2, LR, PH, PW,
                                STATS_RTOL, W, assert_grads_close,
                                assert_leaves_close, assert_params_after_adam,
                                leaves, run_both, stereo_batch)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
# -- batch norm in train mode ---------------------------------------------------

def _module_variables(module: torch.nn.Module):
    """A port module's weights as the flax module's variables."""
    params, stats = bridge.jax_from_state_dict(
        {f"encoder.{k}": v for k, v in module.state_dict().items()})
    return {"params": params["encoder"], "batch_stats": stats["encoder"]}


def _seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded weights and non-trivial running statistics."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.3)
    return module


@pytest.mark.parametrize("kind", ["convbn", "resblock"])
def test_batch_norm_train_mode_matches_flax(kind):
    features = 16
    if kind == "convbn":
        port = _seeded(port_ae.ConvBN(8, features, 3), 0)
        flax_mod = jax_ae._ConvBN(features, 3)
        cin = 8
    else:
        port = _seeded(port_ae.ResBlock(features), 1)
        flax_mod = jax_ae._ResBlock(features)
        cin = features
    x = np.random.default_rng(2).normal(0, 2, (2, 10, 12, cin)) \
        .astype(np.float32)
    variables = _module_variables(port)
    want, mut = flax_mod.apply(variables, jnp.asarray(x), True,
                               mutable=["batch_stats"])
    stats = {}
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2), True, stats)
    got = got.permute(0, 2, 3, 1).detach().numpy()
    want = np.asarray(want)
    # float32 statistics summed in another order: 1e-5 of the largest output
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert len(stats) == (1 if kind == "convbn" else 2)

    # new running stats = 0.9 * old + 0.1 * batch, flax's order
    before = _module_variables(port)["batch_stats"]
    port_ae.apply_batch_stats(stats)
    after = _module_variables(port)["batch_stats"]
    want_stats = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
    for path, w in leaves(want_stats).items():
        g = leaves(after)[path]
        assert np.abs(g - w).max() <= 1e-6 * max(1.0, np.abs(w).max()), path
        assert not np.array_equal(g, leaves(before)[path]), path


def test_batch_statistics_are_flax_fast_variance():
    """`batch_norm`'s batch mean and biased variance against flax's
    `_compute_stats` on the same input (bf16 input reduced in float32)."""
    rng = np.random.default_rng(3)
    bn = _seeded(torch.nn.BatchNorm2d(6), 4)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        x = rng.normal(3.0, 2.0, (3, 7, 9, 6)).astype(np.float32)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
        stats = {}
        out = port_ae.batch_norm(xt, bn, True, stats)
        assert out.dtype == torch.float32
        mean, var = stats[bn]
        jx = jnp.asarray(x).astype(jdt)
        wmean, wvar = _compute_stats(jx, (0, 1, 2), None)
        # float32 means of 189 values summed in another order: within 16
        # ulps of their magnitude; the fast variance subtracts two of them,
        # so it inherits the ulps of mean(x**2)
        ulp = np.finfo(np.float32).eps
        mean2 = float(np.asarray(jnp.mean(jnp.square(
            jx.astype(jnp.float32)), (0, 1, 2))).max())
        assert np.abs(mean.numpy() - np.asarray(wmean)).max() \
            <= 16 * ulp * float(np.abs(np.asarray(wmean)).max())
        assert np.abs(var.numpy() - np.asarray(wvar)).max() \
            <= 16 * ulp * mean2


def test_frozen_batch_norm_normalizes_by_the_batch_and_keeps_the_stats():
    port = _seeded(port_ae.ResBlock(8), 5)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (2, 8, 6, 7)).astype(np.float32))
    frozen = port(x, True, None)
    stats = {}
    updating = port(x, True, stats)
    assert torch.equal(frozen, updating)
    assert not torch.equal(frozen, port(x))          # not the running stats
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_remat_gives_the_same_grads_and_updates_the_stats_once():
    """remat recomputes each residual block in the backward pass: the
    blocks run twice, the statistics are recorded and applied once, and the
    gradients and new state are bit-equal to the run without it."""
    x, y = stereo_batch(7, 2)
    results = {}
    for remat in (True, False):
        ae, pc = tiny_configs(2)
        model = build_model(ae.replace(remat=remat), pc, device="cpu",
                            seed=4)
        calls = []
        block = model.encoder.res.blocks[0]
        # a pre-hook: the recompute stops early, once the backward has
        # the tensors it needs, so a hook after the forward would not run
        block.register_forward_pre_hook(lambda *a: calls.append(1))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        optimizer = Optimizer(model, ae, pc, 10)
        mask = gaussian_position_mask(H, W, PH, PW)
        step = port_step.make_train_step(model, optimizer, si_mask=mask)
        step(x, y)
        results[remat] = (
            {n: p.grad.clone() for n, p in model.named_parameters()},
            model.state_dict(), len(calls), before)
    grads_r, state_r, calls_r, before = results[True]
    grads_p, state_p, calls_p, _ = results[False]
    # the encoder's first block: x's train-mode forward (+ its recompute
    # with remat) and the side image's encode
    assert (calls_r, calls_p) == (3, 2)
    for n in grads_p:
        assert torch.equal(grads_r[n], grads_p[n]), n
    for k in state_p:
        assert torch.equal(state_r[k], state_p[k]), k
    # once: 0.9 * old + 0.1 * batch, not applied twice
    ae, pc = tiny_configs(2)
    fresh = build_model(ae, pc, device="cpu", seed=4)
    stats = {}
    with torch.no_grad():
        port_step.forward_losses(fresh, torch.from_numpy(x),
                                 torch.from_numpy(y),
                                 gaussian_position_mask(H, W, PH, PW),
                                 train=True, bn_stats=stats)
    port_ae.apply_batch_stats(stats)
    for k, v in fresh.state_dict().items():
        if "running" in k:
            assert torch.equal(v, state_r[k]), k
            assert not torch.equal(v, before[k]), k


# -- one train step against the JAX package -----------------------------------

CASES = {"si_b1": ("si", 1), "ae_b2": ("ae", 2)}


@pytest.fixture(scope="module", params=sorted(CASES))
def stepped(request):
    mode, batch = CASES[request.param]
    ae, pc = tiny_configs(batch)
    ae = ae.replace(AE_only=(mode == "ae"))
    x, y = stereo_batch(11 + batch, batch)
    return run_both(ae, pc, x, y)


def test_train_step_loss_metrics_and_search_match(stepped):
    got, want = stepped
    assert np.array_equal(got["symbols"], want["symbols"])
    if want["y_syn"] is None:
        assert got["y_syn"] is None
    else:
        assert np.array_equal(got["y_syn"], want["y_syn"])
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-5,
                                   atol=1e-30, err_msg=k)
    assert got["step"] == want["step"] == 1


def test_train_step_grads_match(stepped):
    got, want = stepped
    assert_grads_close(got["grads"], want["grads"])


def test_train_step_new_state_matches(stepped):
    got, want = stepped
    assert_leaves_close(got["batch_stats"], want["batch_stats"], STATS_RTOL,
                        "batch_stats")
    kinks = assert_grads_close(got["grads"], want["grads"])
    banded = assert_params_after_adam(got["params"], want["params"],
                                      want["old"], want["grads"], LR,
                                      "params", kinks)
    # the elements held to the Adam band are a sliver of the model
    total = sum(v.size for v in leaves(want["params"]).values())
    assert banded <= 1e-3 * total


def test_train_step_opt_state_matches(stepped):
    got, want = stepped
    kinks = assert_grads_close(got["grads"], want["grads"])
    g_tree, w_tree = leaves(got["opt_state"]), leaves(want["opt_state"])
    assert set(g_tree) == set(w_tree)
    for path, w in w_tree.items():
        g = g_tree[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if path[-1] == "count":
            assert int(g) == int(w) == 1, path
            continue
        moment = path.index("mu" if "mu" in path else "nu")
        if path[moment + 1:] in kinks:
            # mu = 0.1 g, nu = 0.001 g**2: the kink's bound, twice for nu
            assert np.linalg.norm(g - w) <= 2 * KINK_REL_L2 * \
                np.linalg.norm(w), path
            continue
        bound = (2 if path[moment] == "nu" else 1) * GRAD_RTOL
        assert np.abs(g - w).max() <= bound * np.abs(w).max() + 1e-30, path
    # every masked leaf of the JAX state is masked in the port's too
    assert jax.tree_util.tree_structure(got["opt_state"]) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            np.asarray, want["opt_state"]))
