"""The port's width-sharded train step (`parallel/data_parallel.py`
`make_spatial_train_step`) over 4 gloo ranks, a (1 data, 4 spatial) mesh
(the data axis with the search sharded is tests/test_torch_parallel_spatial.py's
(2, 4) mesh; the data axis's step is tests/test_torch_parallel_dp.py's), on
the CPU, from the same seeded weights as the JAX package's steps: the
tiny configuration at 16x96 with 8x12 patches (tests/test_spatial.py's
geometry), global batch 2 in 2 micro-batches (`grad_accum` 2), the
Gaussian prior, the rate hinge on.

The JAX package's `make_spatial_train_step` on the same mesh of 4 of the
virtual CPU devices shards the convs by width under GSPMD. Its loss and
metrics are the global-batch program's, but its gradients are not: every
encoder and decoder leaf lies up to 30% from its own global-batch step's
(`build_train_step_fn` under one jit, which its data-parallel step matches
within 6e-6), at spatial 2 and 4, with remat on or off (a fault of the
reference, ROADMAP Queue 3). So the port's step is held against JAX's
spatial step in the loss and metrics, and against JAX's global-batch step
in everything, at the bounds of `tests/test_torch_train_step.py`: the loss
and metrics within rtol 1e-5, the gradients within 5e-5 of each leaf's
largest magnitude (a ReLU's kink: at most 3% of the leaves within 25%
relative L2), the batch statistics within 1e-5, the parameters within 1e-6
where the gradient is not near zero and 2 * lr where it is.

The port runs the convs whole on every spatial rank and shards only the
search (a deviation, ROADMAP Queue 3), so the ranks of the data row hold
the same state after the step, bit for bit: every rank's parameters and
statistics are pinned equal. One spawn (a `file://` rendezvous in tmp_path) while the
JAX steps compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsin_tpu.ops.sifinder import gaussian_position_mask as jax_mask
from dsin_tpu.parallel import data_parallel as jax_dp
from dsin_tpu.parallel import mesh as jax_mesh
from dsin_tpu.train import step as jax_step
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.parallel.launch import run_ranks
from torch_parallel_parity import (Background, jax_sharded_step, port_result,
                                   states_equal)
from torch_train_parity import (LR, STATS_RTOL, assert_grads_close,
                                assert_leaves_close, assert_params_after_adam,
                                leaves)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import torch_parallel_ranks as ranks

H, W, PH, PW = 16, 96, 8, 12
SEED = 3


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    ae, pc = tiny_configs(2)
    ae = ae.replace(crop_size=(H, W), eval_crop_size=(H, W),
                    y_patch_size=(PH, PW))
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    y = np.roll(x, 5, axis=2) + rng.normal(0, 4, x.shape).astype(np.float32)
    y = np.clip(y, 0, 255).astype(np.float32)
    init = str(tmp_path_factory.mktemp("spatial_step_rdzv") / "rdzv")
    spec = dict(ae=str(ae), pc=str(pc), x=x, y=y, spatial=4, grad_accum=2,
                seed=SEED)
    ranks_run = Background(run_ranks, ranks.train_cases, 4, ([spec],),
                           "gloo", "cpu", init, 150.0, 1)
    mask = jnp.asarray(jax_mask(H, W, PH, PW))
    global_run = Background(
        jax_sharded_step, ae, pc, x, y, SEED, lambda jm, tx: jax.jit(
            jax_step.build_train_step_fn(jm, tx, si_mask=mask,
                                         grad_accum=2)))
    mesh = jax_mesh.make_mesh(num_devices=4, spatial=4)
    spatial = jax_sharded_step(
        ae, pc, x, y, SEED, lambda jm, tx: jax_dp.make_spatial_train_step(
            jm, tx, mesh, H, W, donate=False, grad_accum=2))
    return ([r[0] for r in ranks_run.result(180.0)], spatial,
            global_run.result(180.0))


def test_every_rank_holds_the_same_state(stepped):
    got_ranks = stepped[0]
    assert [r["coords"] for r in got_ranks] == [(0, s) for s in range(4)]
    assert states_equal(got_ranks)
    for r in got_ranks[1:]:
        assert r["metrics"] == got_ranks[0]["metrics"]


@pytest.mark.parametrize("which", ["spatial", "global"])
def test_the_loss_and_metrics_match_jaxs_steps(stepped, which):
    got = port_result(stepped[0][0])
    want = stepped[1] if which == "spatial" else stepped[2]
    assert got["step"] == want["step"] == 1
    assert want["metrics"]["pc_loss"] > 0
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-5,
                                   err_msg=k)


def test_the_step_matches_jaxs_global_batch_step(stepped):
    got, want = port_result(stepped[0][0]), stepped[2]
    kinks = assert_grads_close(got["grads"], want["grads"])
    assert_leaves_close(got["batch_stats"], want["batch_stats"], STATS_RTOL,
                        "batch_stats")
    assert_params_after_adam(got["params"], want["params"], want["old"],
                             want["grads"], LR, "params", kinks)


def test_the_batch_statistics_match_jaxs_spatial_step(stepped):
    """The running statistics come from the forward, which JAX's spatial
    step computes as the global-batch program does."""
    got, want = port_result(stepped[0][0]), stepped[1]
    assert_leaves_close(got["batch_stats"], want["batch_stats"], STATS_RTOL,
                        "batch_stats")


def test_jaxs_spatial_step_is_not_its_global_step(stepped):
    """Pins the reference's fault (ROADMAP Queue 3; `python
    tests/jax_spatial_gradients.py` prints its table): JAX's width-sharded
    step's gradients lie farther than 1e-2 of a leaf's largest magnitude
    from its global-batch step's, 200 times the train step's bound. When
    this fails, the JAX step has become the global-batch program, and the
    port's step can be held against it directly."""
    spatial, glob = leaves(stepped[1]["grads"]), leaves(stepped[2]["grads"])
    far = [k for k, r in glob.items()
           if np.abs(spatial[k] - r).max() > 1e-2 * np.abs(r).max()]
    assert far
