"""The port's train step against the JAX package's in bfloat16 and with
gradient accumulation, at the tiny configuration (batch 2, SI path), from
the same weights and seeded batches (`tests/torch_train_parity.py`).

Bounds:
  * float32 with `grad_accum = 2` on distinct micro-batches: the bounds of
    `tests/test_torch_train_step.py` (float32 in another summation order,
    a ReLU's kink at an input of exactly 0: the first micro-batch here
    meets one in the encoder's first layer);
  * `grad_accum = 2` on duplicated micro-batches against the full batch,
    in the port alone: metrics within rtol 2e-5 and parameters within
    2e-3 absolute, the JAX package's own bounds for the same check
    (tests/test_train_step.py): the full batch's statistics reduce twice
    as many elements, and Adam's first step turns the ulps into up to
    2 * lr;
  * `compute_dtype = 'bfloat16'`: the two packages' bf16 convolutions round
    their float32 sums to 8 bits in another order, and a bottleneck that
    moves by an ulp can flip a quantization symbol, which changes a whole
    8x8 block of the decoded image at this size. So the bf16 step is held
    to bf16's own distance: the relative L2 distance of all gradients (and
    of the first moments) between the packages at most 3 times the
    distance between the JAX package's bf16 and float32 steps on the same
    inputs, at least 97% of the symbols equal, the loss and metrics within
    rtol 2e-2, the new statistics within 5% relative L2, and every
    parameter within 2 * lr + 1e-6 of JAX's (Adam's first step moves each
    by at most lr, and each package rounds its sum).
"""

import numpy as np
import pytest

from dsin_tpu_torch.entry import tiny_configs
from torch_train_parity import (LR, PARAM_ATOL, STATS_RTOL,
                                assert_grads_close, assert_leaves_close,
                                assert_params_after_adam, leaves, run_both,
                                stereo_batch)
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops.sifinder import gaussian_position_mask
from dsin_tpu_torch.train import step as port_step
from dsin_tpu_torch.train.optim import Optimizer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def batch2():
    return stereo_batch(21, 2)


@pytest.fixture(scope="module")
def f32_step(batch2):
    ae, pc = tiny_configs(2)
    return run_both(ae, pc, *batch2)


@pytest.fixture(scope="module")
def bf16_step(batch2):
    ae, pc = tiny_configs(2)
    return run_both(ae.replace(compute_dtype="bfloat16"), pc, *batch2)


def _flat(tree):
    return np.concatenate([v.ravel() for _, v in sorted(leaves(tree).items())])


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_float32_batch_of_two_matches(f32_step):
    got, want = f32_step
    assert np.array_equal(got["y_syn"], want["y_syn"])
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-5,
                                   err_msg=k)
    kinks = assert_grads_close(got["grads"], want["grads"])
    assert_leaves_close(got["batch_stats"], want["batch_stats"], STATS_RTOL,
                        "batch_stats")
    assert_params_after_adam(got["params"], want["params"], want["old"],
                             want["grads"], LR, "params", kinks)


def test_bfloat16_step_within_bf16_distance(bf16_step, f32_step):
    got, want = bf16_step
    _, want32 = f32_step
    floor = _rel_l2(_flat(want["grads"]), _flat(want32["grads"]))
    assert 0 < floor < 0.5
    assert _rel_l2(_flat(got["grads"]), _flat(want["grads"])) <= 3 * floor
    mu = lambda t: _flat({k: v["inner_state"]["0"]["mu"]  # noqa: E731
                          for k, v in t["inner_states"].items()
                          if k != "frozen"})
    assert _rel_l2(mu(got["opt_state"]), mu(want["opt_state"])) <= 3 * floor
    assert float(np.mean(got["symbols"] == want["symbols"])) >= 0.97
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=2e-2,
                                   err_msg=k)
    assert _rel_l2(_flat(got["batch_stats"]),
                   _flat(want["batch_stats"])) <= 0.05
    diff = np.abs(_flat(got["params"]) - _flat(want["params"]))
    assert float(diff.max()) <= 2 * LR + PARAM_ATOL


def test_grad_accum_matches_jax(batch2):
    ae, pc = tiny_configs(2)
    got, want = run_both(ae, pc, *batch2, grad_accum=2)
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-5,
                                   err_msg=k)
    kinks = assert_grads_close(got["grads"], want["grads"],
                               "accumulated grads")
    assert_leaves_close(got["batch_stats"], want["batch_stats"], STATS_RTOL,
                        "batch_stats")
    assert_params_after_adam(got["params"], want["params"], want["old"],
                             want["grads"], LR, "params", kinks)
    assert got["step"] == want["step"] == 1


def test_grad_accum_on_duplicated_micro_batches_equals_the_full_batch():
    x1, y1 = stereo_batch(23, 1)
    x, y = np.concatenate([x1, x1]), np.concatenate([y1, y1])
    mask = gaussian_position_mask(40, 48, 20, 24)
    out = []
    for accum in (1, 2):
        ae, pc = tiny_configs(2)
        model = build_model(ae, pc, device="cpu", seed=3)
        optimizer = Optimizer(model, ae, pc, 10)
        step = port_step.make_train_step(model, optimizer, si_mask=mask,
                                         grad_accum=accum)
        state, metrics = step(x, y)
        assert state.step == 1
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: v.detach().clone()
                     for k, v in model.named_parameters()}))
    (m_full, sd_full), (m_acc, sd_acc) = out
    for k in m_full:
        np.testing.assert_allclose(m_acc[k], m_full[k], rtol=2e-5,
                                   atol=1e-5, err_msg=k)
    # the parameters; the running statistics differ by design: they chain
    # through the micro-batches, two updates where the full batch makes one
    for k, v in sd_full.items():
        np.testing.assert_allclose(sd_acc[k].numpy(), v.numpy(), rtol=2e-5,
                                   atol=2e-3, err_msg=k)
