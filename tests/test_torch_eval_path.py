"""The port's eval path against the JAX package: distortions, MS-SSIM, the
losses and the whole eval forward of `make_inference_step` /
`make_eval_step`, at the tiny configuration (`entry.tiny_configs`, 40x48,
20x24 patches) on the same weights (`bridge.py`) and inputs.

Bounds, each stated where it is asserted:
  * metrics on int-truncated operands (`astype(int32)` in both) are exact:
    their float32 sums are sums of integers below 2**24;
  * metrics on float operands, MS-SSIM and the losses agree within 1e-5
    relative (float32 in another summation order); MS-SSIM in the
    distortion, near 1, within 1e-6 absolute, so K_ms_ssim (1 - MS-SSIM)
    within K_ms_ssim * 1e-6;
  * the forward: symbols exact, images within 1e-3 of 255 and bpp within
    rtol 1e-5 as in tests/test_torch_slice_entry.py (float32 nets summing in
    another order), with every patch's top-two search margin above 1e-4 so
    no argmax can flip under that noise; loss within rtol 1e-4 (it adds the
    image distortion and beta = 500 times the rate); PSNR on truncated
    pixels within 1e-3 dB (a pixel whose two float values straddle an
    integer truncates to neighbours).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsin_tpu.config import parse_config as jax_parse_config
from dsin_tpu.eval.msssim_np import multiscale_ssim_np as jax_msssim_np
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu.ops import metrics as jax_metrics
from dsin_tpu.ops.msssim import multiscale_ssim as jax_msssim
from dsin_tpu.ops.sifinder import gaussian_position_mask
from dsin_tpu.train import losses as jax_losses
from dsin_tpu.train import step as jax_step
from dsin_tpu_torch import bridge
from dsin_tpu_torch.data.synthetic import make_stereo_pair
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.eval.msssim_np import multiscale_ssim_np
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops import metrics as port_metrics
from dsin_tpu_torch.ops import sifinder as sf
from dsin_tpu_torch.ops.msssim import multiscale_ssim
from dsin_tpu_torch.train import losses as port_losses
from dsin_tpu_torch.train import step as port_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, PH, PW = 40, 48, 20, 24
RTOL = 1e-5


def _images(seed, n, h=H, w=W, noise=6.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    x_out = np.clip(x + rng.normal(0, noise, x.shape), 0, 255)
    return x, x_out.astype(np.float32)


@pytest.mark.parametrize("is_training", [True, False])
@pytest.mark.parametrize("target", ["mae", "mse", "psnr", "ms_ssim"])
def test_compute_distortions_match(target, is_training):
    ae, _ = tiny_configs()
    cfg = ae.replace(distortion_to_minimize=target)
    x, x_out = _images(3, 2, 64, 80)
    got = port_metrics.compute_distortions(
        cfg, torch.from_numpy(x), torch.from_numpy(x_out), is_training)
    want = jax_metrics.compute_distortions(
        jax_parse_config(str(cfg)), jnp.asarray(x), jnp.asarray(x_out),
        is_training)
    for name in ("mae", "mse", "psnr"):
        cast = (not is_training) or target != name
        g, w = float(getattr(got, name)), float(getattr(want, name))
        if name in ("mae", "mse") and cast:
            assert g == w, (name, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=name)
    d_got, d_want = float(got.d_loss_scaled), float(want.d_loss_scaled)
    if target == "ms_ssim":
        # MS-SSIM near 1 within 1e-6 (a few float32 ulps); d = K (1 - it)
        np.testing.assert_allclose(float(got.ms_ssim), float(want.ms_ssim),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(d_got, d_want, rtol=0,
                                   atol=cfg.K_ms_ssim * 1e-6)
    else:
        assert got.ms_ssim is None and want.ms_ssim is None
        np.testing.assert_allclose(d_got, d_want, rtol=RTOL)


@pytest.mark.parametrize("shape", [(2, 64, 80, 3), (1, 45, 61, 3)])
def test_msssim_matches_jax_and_the_numpy_oracle(shape):
    rng = np.random.default_rng(4)
    smooth = np.cumsum(rng.normal(0, 6, shape), axis=2) + 128
    a = np.clip(smooth, 0, 255).astype(np.float32)
    b = np.clip(a + rng.normal(0, 8, shape), 0, 255).astype(np.float32)
    got = float(multiscale_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(
        got, float(jax_msssim(jnp.asarray(a), jnp.asarray(b))), rtol=RTOL)
    # the float64 oracle: float32 against float64 sums, 1e-4
    np.testing.assert_allclose(got, multiscale_ssim_np(a, b), rtol=1e-4)
    assert multiscale_ssim_np(a, b) == jax_msssim_np(a, b)
    assert float(multiscale_ssim(torch.from_numpy(a),
                                 torch.from_numpy(a))) == pytest.approx(1.0)


@pytest.fixture(scope="module")
def pair():
    """Weights of a seeded port model, both as the port's model and as the
    JAX package's trees, and a stereo-like input pair."""
    ae, pc = tiny_configs()
    pc = pc.replace(regularization_factor=0.01)   # exercise the pc term
    model = build_model(ae, pc, device="cpu", seed=2)
    params, stats = bridge.jax_from_state_dict(model.state_dict())
    left, right = make_stereo_pair(np.random.default_rng(2), H, W + 8)
    x = left[None, :, :W].astype(np.float32)
    y = right[None, :, 8:].astype(np.float32)
    jmodel = JaxDSIN(jax_parse_config(str(ae)), jax_parse_config(str(pc)))
    state = jax_step.TrainState(params=params, batch_stats=stats,
                                opt_state=(), step=jnp.int32(0))
    return dict(model=model, params=params, jmodel=jmodel, state=state,
                x=x, y=y, ae=ae, pc=pc)


def test_losses_match(pair):
    model, ae, pc, params = pair["model"], pair["ae"], pair["pc"], \
        pair["params"]
    jae, jpc = pair["jmodel"].ae_config, pair["jmodel"].pc_config
    got = port_losses.regularization_losses(model, ae, pc)
    want = jax_losses.regularization_losses(params, jae, jpc)
    assert set(got) == set(want) == {"enc", "dec", "centers", "pc"}
    for name in got:
        assert float(want[name]) > 0
        np.testing.assert_allclose(float(got[name].detach()),
                                   float(want[name]), rtol=RTOL,
                                   err_msg=name)
    rng = np.random.default_rng(5)
    bc = rng.uniform(0, 3, (2, 5, 6, 8)).astype(np.float32)
    heat = rng.uniform(0, 1, bc.shape).astype(np.float32)
    for heatmap in (heat, None):
        r_port = port_losses.rate_loss(
            torch.from_numpy(bc),
            None if heatmap is None else torch.from_numpy(heatmap), 0.08,
            500)
        r_jax = jax_losses.rate_loss(
            jnp.asarray(bc), None if heatmap is None else jnp.asarray(heatmap),
            0.08, 500)
        for a, b in zip(r_port, r_jax):
            np.testing.assert_allclose(float(a), float(b), rtol=RTOL)
        d = torch.tensor(3.25)
        np.testing.assert_allclose(
            float(port_losses.total_loss(d, r_port, got)),
            float(jax_losses.total_loss(jnp.float32(3.25), r_jax, want)),
            rtol=RTOL)
    x, x_out = _images(6, 2)
    np.testing.assert_allclose(
        float(port_losses.si_l1_loss(torch.from_numpy(x),
                                     torch.from_numpy(x_out))),
        float(jax_losses.si_l1_loss(jnp.asarray(x), jnp.asarray(x_out))),
        rtol=RTOL)


def test_regularization_reads_the_stored_masked_weight(pair):
    """The masked 3-D convs store the unmasked weight and mask it at use;
    the L2 term sums the stored weight, as the JAX package sums its stored
    kernel."""
    conv = pair["model"].probclass.conv0
    assert float((conv.weight * (1 - conv.mask)).abs().sum()) > 0
    want = sum(0.5 * float(torch.sum(m.weight ** 2)) for m in
               (getattr(pair["model"].probclass, f"conv{i}")
                for i in range(4)))
    np.testing.assert_allclose(
        float(port_losses.l2_of_kernels(pair["model"].probclass)), want,
        rtol=RTOL)


def _margins_clear(model, x, y):
    with torch.no_grad():
        x_dec = model.decode(model.encode(torch.from_numpy(x)).qbar)
        y_dec = model.decode(model.encode(torch.from_numpy(y)).qbar)
    res = sf.search_single(x_dec[0], torch.from_numpy(y[0]), y_dec[0],
                           sf.gaussian_position_mask(H, W, PH, PW), PH, PW)
    top2 = torch.topk(res.score_map.reshape(-1, res.score_map.shape[-1]),
                      2, dim=0).values
    return float((top2[0] - top2[1]).min()) > 1e-4


@pytest.fixture(scope="module")
def forwards(pair):
    mask = gaussian_position_mask(H, W, PH, PW)
    x, y = pair["x"], pair["y"]
    assert _margins_clear(pair["model"], x, y)
    got = port_step.make_inference_step(pair["model"], si_mask=mask)(x, y)
    want = jax.device_get(jax_step.make_inference_step(
        pair["jmodel"], si_mask=jnp.asarray(mask))(pair["state"], x, y))
    return got, want


def test_inference_dict_matches_jax(forwards):
    got, want = forwards
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["symbols"].numpy(), want["symbols"])
    for key in ("x_dec", "x_with_si", "y_syn"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=1e-3, err_msg=key)
    np.testing.assert_allclose(float(got["bpp"]), float(want["bpp"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["mae"]), float(want["mae"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(got["psnr"]), float(want["psnr"]),
                               rtol=0, atol=1e-3)


def test_eval_step_metrics_match_jax(pair):
    mask = gaussian_position_mask(H, W, PH, PW)
    got = port_step.make_eval_step(pair["model"], si_mask=mask)(
        pair["x"], pair["y"])
    want = jax.device_get(jax_step.make_eval_step(
        pair["jmodel"], si_mask=jnp.asarray(mask))(
            pair["state"], pair["x"], pair["y"]))
    assert set(got) == set(want)
    for key in want:
        tol = dict(rtol=0, atol=1e-3) if key == "psnr" else dict(rtol=1e-4)
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   err_msg=key, **tol)


def test_ae_only_forward_matches_jax(pair):
    ae, pc = pair["ae"].replace(AE_only=True), pair["pc"]
    model = build_model(ae, pc, device="cpu", seed=2)
    got = port_step.make_inference_step(model)(pair["x"], pair["y"])
    params, stats = bridge.jax_from_state_dict(model.state_dict())
    jmodel = JaxDSIN(jax_parse_config(str(ae)), jax_parse_config(str(pc)))
    state = jax_step.TrainState(params=params, batch_stats=stats,
                                opt_state=(), step=jnp.int32(0))
    want = jax.device_get(jax_step.make_inference_step(jmodel)(
        state, pair["x"], pair["y"]))
    assert got["y_syn"] is None and want["y_syn"] is None
    assert not got["x_with_si"].any()
    np.testing.assert_array_equal(got["symbols"].numpy(), want["symbols"])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4)


@pytest.mark.parametrize("impl", ["auto", "torch", "kernel"])
def test_a_mask_checked_once_gives_what_checking_per_image_gives(pair, impl):
    """The step checks the prior once (`check_mask`); a search handed the
    raw mask checks it per call. Both give the same y_syn bit for bit, on
    the kernel route (its plain version here) and the torch route."""
    model = pair["model"]
    model.ae_config = model.ae_config.replace(sifinder_impl=impl)
    try:
        mask = torch.from_numpy(gaussian_position_mask(H, W, PH, PW))
        checked = sf.check_mask(mask, PH, PW)
        assert checked.factors is not None
        x, y = torch.from_numpy(pair["x"]), torch.from_numpy(pair["y"])
        with torch.no_grad():
            x_dec = model.decode(model.encode(x).qbar)
            y_dec = model.decode(model.encode(y).qbar)
        once = sf.synthesize_side_image(x_dec, y, y_dec, checked, PH, PW,
                                        model.ae_config)
        each = sf.synthesize_side_image(x_dec, y, y_dec, mask, PH, PW,
                                        model.ae_config)
        assert torch.equal(once, each)
        infer = port_step.make_inference_step(model, si_mask=mask)
        assert torch.equal(infer(pair["x"], pair["y"])["y_syn"], each)
    finally:
        model.ae_config = model.ae_config.replace(sifinder_impl="auto")


def test_a_custom_mask_checks_to_no_factors_and_the_wrong_size_raises(pair):
    mask = gaussian_position_mask(H, W, PH, PW).copy()
    mask[3, 4, 1] *= 1.0001
    assert sf.check_mask(mask, PH, PW).factors is None
    small = sf.check_mask(gaussian_position_mask(H, W + 24, PH, PW), PH, PW)
    x = torch.zeros((1, H, W, 3))
    with pytest.raises(ValueError, match="checked mask has shape"):
        sf.synthesize_side_image(x, x, x, small, PH, PW, pair["ae"])


def test_the_train_branch_raises(pair):
    """The train branch runs (its parity with the JAX package is
    tests/test_torch_train_step.py); batch statistics asked of the eval
    branch, which computes none, raise."""
    x, y = torch.from_numpy(pair["x"]), torch.from_numpy(pair["y"])
    stats = {}
    loss, _ = port_step.forward_losses(pair["model"], x, y, None, train=True,
                                       bn_stats=stats)
    assert loss.requires_grad and len(stats) == sum(
        isinstance(m, torch.nn.BatchNorm2d) for m in pair["model"].modules())
    with pytest.raises(ValueError, match="only the train branch"):
        port_step.forward_losses(pair["model"], x, y, None, bn_stats={})
