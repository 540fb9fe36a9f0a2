"""The port's data-parallel train step (`parallel/data_parallel.py`
`make_sharded_train_step`) over 2 gloo ranks against the JAX package's
`make_sharded_train_step` on a 2-device mesh, on the CPU, from the same
seeded weights (the tiny configuration, 40x48 crops, the SI path).

GSPMD runs the JAX step as ONE global-batch program; the port's ranks each
hold their rows, so wherever a nonlinearity sees the whole batch the port
must reduce across ranks first, or its gradient is the average of per-rank
losses' gradients. The cases:
  * batch 2 (one row a rank), `grad_accum` 1, with H_target set between
    the two rows' own H_soft: a rank holding only its row would see its
    hinge off (or on) where the global H_soft is above the target, and the
    batch norms' train-mode statistics differ from either row's;
  * batch 4 (two rows a rank), `grad_accum` 2: micro k is global rows
    k::2, which are each rank's rows k::2.
Bounds, those of `tests/test_torch_train_step.py` (float32 in another
summation order, a ReLU's kink): the loss and metrics within rtol 1e-5,
the gradients (JAX's read from Adam's first moment, the port's after the
average over the ranks) within 5e-5 of each leaf's largest magnitude, the
new batch statistics within 1e-5, the parameters within 1e-6 where the
gradient is not near zero, 2 * lr where it is. Both ranks end bit-equal.
One spawn of the 2 ranks (a `file://` rendezvous in tmp_path) runs both
cases while the JAX steps compile.
"""

import numpy as np
import pytest
import torch

from dsin_tpu.ops.sifinder import gaussian_position_mask as jax_mask
from dsin_tpu.parallel import data_parallel as jax_dp
from dsin_tpu.parallel import mesh as jax_mesh
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.parallel.launch import run_ranks
from dsin_tpu_torch.train import step as port_step
from torch_parallel_parity import (Background, jax_sharded_step, port_result,
                                   states_equal)
from torch_train_parity import (H, LR, PH, PW, STATS_RTOL, W,
                                assert_grads_close, assert_leaves_close,
                                assert_params_after_adam, stereo_batch)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import torch_parallel_ranks as ranks

SEED = 3


def _row_h_soft(ae, pc, x, y):
    """Each row's H_soft from a train-mode forward of that row alone."""
    model = build_model(ae, pc, device="cpu", seed=SEED)
    mask = port_step._checked(model, jax_mask(H, W, PH, PW))
    out = []
    for i in range(x.shape[0]):
        with torch.no_grad():
            _, aux = port_step.forward_losses(
                model, torch.from_numpy(x[i:i + 1]),
                torch.from_numpy(y[i:i + 1]), mask, train=True)
        out.append(float(aux["H_soft"]))
    return out


@pytest.fixture(scope="module")
def cases():
    ae2, pc = tiny_configs(2)
    x2, y2 = stereo_batch(21, 2)
    h = _row_h_soft(ae2, pc, x2, y2)
    ae2 = ae2.replace(H_target=0.5 * (h[0] + h[1]))
    x4, y4 = stereo_batch(22, 4)
    ae4 = tiny_configs(4)[0]
    return {"hinge": dict(ae=ae2, pc=pc, x=x2, y=y2, grad_accum=1,
                          row_h_soft=h),
            "accum": dict(ae=ae4, pc=pc, x=x4, y=y4, grad_accum=2)}


@pytest.fixture(scope="module")
def stepped(cases, tmp_path_factory):
    init = str(tmp_path_factory.mktemp("dp_rdzv") / "rdzv")
    specs = [dict(ae=str(c["ae"]), pc=str(c["pc"]), x=c["x"], y=c["y"],
                  spatial=0, grad_accum=c["grad_accum"], seed=SEED)
             for c in cases.values()]
    ranks_run = Background(run_ranks, ranks.train_cases, 2, (specs,),
                           "gloo", "cpu", init, 150.0, 1)
    mesh = jax_mesh.make_mesh(num_devices=2)
    mask = jax_mask(H, W, PH, PW)
    # the two JAX steps compile on threads of their own, beside the ranks
    jax_runs = {name: Background(
        jax_sharded_step, c["ae"], c["pc"], c["x"], c["y"], SEED,
        lambda jm, tx, a=c["grad_accum"]: jax_dp.make_sharded_train_step(
            jm, tx, mesh, si_mask=mask, donate=False, grad_accum=a))
        for name, c in cases.items()}
    want = {name: run.result(180.0) for name, run in jax_runs.items()}
    got = ranks_run.result(180.0)
    return {name: ([r[i] for r in got], want[name])
            for i, name in enumerate(cases)}


@pytest.mark.parametrize("name", ["hinge", "accum"])
def test_the_step_matches_jaxs_sharded_step(stepped, name):
    got_ranks, want = stepped[name]
    assert [r["coords"] for r in got_ranks] == [(0, 0), (1, 0)]
    assert states_equal(got_ranks)
    got = port_result(got_ranks[0])
    assert got["step"] == want["step"] == 1
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-5,
                                   err_msg=k)
    kinks = assert_grads_close(got["grads"], want["grads"])
    assert_leaves_close(got["batch_stats"], want["batch_stats"], STATS_RTOL,
                        "batch_stats")
    assert_params_after_adam(got["params"], want["params"], want["old"],
                             want["grads"], LR, "params", kinks)


def test_the_hinge_straddles_the_rows(cases, stepped):
    """The target lies between the rows' own H_soft, and the global step's
    hinge is on (pc_loss > 0), in both packages."""
    h = cases["hinge"]["row_h_soft"]
    target = cases["hinge"]["ae"].H_target
    assert min(h) < target < max(h)
    got_ranks, want = stepped["hinge"]
    assert want["metrics"]["pc_loss"] > 0
    assert got_ranks[0]["metrics"]["pc_loss"] > 0
