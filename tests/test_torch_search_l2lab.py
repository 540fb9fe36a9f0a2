"""The port's L2/LAB search mode (`use_L2andLAB`) against the JAX package:
`rgb_to_lab`, the conv-form distance with its clamp, the additive prior
discount and the arg-min, the cached L2 prep, and the inference step at the
tiny configuration on the same weights (`bridge.py`).

Bounds, each stated where it is asserted:
  * Lab values within 3e-2 absolute: raw pixels up to 255 give XYZ values up
    to 5.3e5 and cube roots up to 81 (an ulp of 7.6e-6); the two packages'
    cube roots sit up to 2 ulps apart (XLA's float32 `cbrt` against a
    float64 power rounded once) and carry an ulp from the power and the 3x3
    product before them, and the Lab matrix weighs them by up to 500 in a
    difference of two: 2 x 500 x 3 x 7.6e-6 = 2.3e-2 (9.5e-3 seen);
  * L2 distances within 1e-5 of the largest term of the map (|x|^2 + |y|^2,
    ~8e9 for Lab values of raw pixels): the terms inherit the Lab values'
    differences and are summed over 288 products in another order; 1.4e-6
    of it is seen at these inputs;
  * indices exact where the top-two margin exceeds twice that bound
    (checked for every patch); planted patches exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsin_tpu.config import parse_config as jax_parse_config
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu.ops import color as jcolor
from dsin_tpu.ops import sifinder as jsf
from dsin_tpu.ops.patches import extract_patches as jax_extract_patches
from dsin_tpu.train import step as jax_step
from dsin_tpu_torch import bridge
from dsin_tpu_torch.config import Config
from dsin_tpu_torch.data.synthetic import make_stereo_pair
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops import color
from dsin_tpu_torch.ops import sifinder as sf
from dsin_tpu_torch.serve.device import DeviceServer
from dsin_tpu_torch.train import step as port_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, PH, PW = 40, 48, 8, 12
LAB_ATOL = 3e-2
L2_RTOL = 1e-5          # of the map's largest term


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    return x, y


def _largest_term(x, y):
    """max |x-patch|^2 + max window |y|^2 in Lab: the scale of the
    conv-form distance's terms."""
    q = color.search_transform(_t(jax_extract_patches(jnp.asarray(x), PH,
                                                      PW)), True)
    r = color.search_transform(_t(y), True)
    return float((q * q).sum(dim=(1, 2, 3)).max()
                 + sf.window_sums(r, PH, PW)[1].max())


def _margins(score_map):
    low = torch.topk(score_map.reshape(-1, score_map.shape[-1]), 2, dim=0,
                     largest=False).values
    return float((low[1] - low[0]).min())


def test_rgb_to_lab_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (24, 32, 3)).astype(np.float32)
    img[0, :8] = np.arange(24, dtype=np.float32).reshape(8, 3) * 1e-3
    img[1, :4] = [[0, 0, 0], [255, 255, 255], [0.04, 0.05, 0.03],
                  [128, 0, 255]]
    got = color.rgb_to_lab(_t(img)).numpy()
    want = np.asarray(jcolor.rgb_to_lab(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=0, atol=LAB_ATOL)
    # the search transform feeds raw pixels to rgb_to_lab in LAB mode, and
    # the [-1, 1] normalization is the same float32 arithmetic
    np.testing.assert_array_equal(color.search_transform(_t(img), True),
                                  got)
    np.testing.assert_array_equal(
        color.normalize_for_search(_t(img), True).numpy(),
        np.asarray(jcolor.normalize_for_search(jnp.asarray(img), True)))


@pytest.mark.parametrize("prior", [False, True])
def test_l2_scores_and_matches_agree_with_jax(prior):
    x, y = _pair(2)
    mask = sf.gaussian_position_mask(H, W, PH, PW) if prior else None
    got = sf.search_single(_t(x), _t(y), _t(y), mask, PH, PW, use_l2=True)
    want = jsf.search_single(jnp.asarray(x), jnp.asarray(y), jnp.asarray(y),
                             None if mask is None else jnp.asarray(mask),
                             PH, PW, use_l2=True)
    bound = L2_RTOL * _largest_term(x, y)
    if not prior:
        # the unmasked map is match_scores' distance clamped at 0
        q = jcolor.search_transform(jax_extract_patches(jnp.asarray(x), PH,
                                                        PW), True)
        raw = np.asarray(jsf.match_scores(
            q, jcolor.search_transform(jnp.asarray(y), True), use_l2=True))
        np.testing.assert_allclose(got.score_map.numpy(),
                                   np.maximum(raw, 0.0), rtol=0, atol=bound)
    np.testing.assert_allclose(got.score_map.numpy(),
                               np.asarray(want.score_map), rtol=0,
                               atol=bound)
    assert _margins(got.score_map) > 2 * bound
    np.testing.assert_array_equal(got.best_flat.numpy(),
                                  np.asarray(want.best_flat))
    np.testing.assert_array_equal(got.y_syn.numpy(), np.asarray(want.y_syn))
    np.testing.assert_allclose(got.best_score.numpy(),
                               np.asarray(want.best_score), rtol=0,
                               atol=bound)


def test_planted_patch_found_exactly():
    """As the JAX package's test_planted_patch_found_l2_lab: x's patch 1
    copied into y at (8, 6) is found there, in both packages."""
    rng = np.random.default_rng(4)
    h, w, ph, pw = 16, 24, 8, 12
    x = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    y[5, 3, :] = 0
    y[8:16, 6:18, :] = x[0:8, 12:24, :]
    got = sf.search_single(_t(x), _t(y), _t(y), None, ph, pw, use_l2=True)
    want = jsf.search_single(jnp.asarray(x), jnp.asarray(y), jnp.asarray(y),
                             None, ph, pw, use_l2=True)
    assert (int(got.row[1]), int(got.col[1])) == (8, 6)
    assert int(got.best_flat[1]) == int(want.best_flat[1])
    np.testing.assert_array_equal(got.y_syn[0:8, 12:24].numpy(),
                                  x[0:8, 12:24])


def test_the_prior_resolves_duplicate_ties():
    """As the JAX package's test_l2_mode_prior_resolves_duplicate_ties: a
    repeated texture at 96x96, where the float32 cancellation noise of the
    distance (terms ~1e9) must not beat the prior: every patch picks its own
    copy."""
    rng = np.random.default_rng(8)
    h, w, ph, pw = 96, 96, 8, 12
    tile = rng.uniform(0, 255, (ph, pw, 3)).astype(np.float32)
    x = np.tile(tile, (h // ph, w // pw, 1))
    mask = sf.gaussian_position_mask(h, w, ph, pw)
    got = sf.search_single(_t(x), _t(x), _t(x), mask, ph, pw, use_l2=True)
    grid = w // pw
    p = np.arange((h // ph) * grid)
    np.testing.assert_array_equal(got.row.numpy(), (p // grid) * ph)
    np.testing.assert_array_equal(got.col.numpy(), (p % grid) * pw)


def test_a_cached_l2_prep_is_bit_identical_to_scratch():
    x, y = _pair(5)
    factors = sf.gaussian_position_mask_factors(H, W, PH, PW)
    prep = sf.build_side_prep(_t(y), _t(y), PH, PW, use_l2=True,
                              mask_factors=factors)
    assert prep.inv_window_std is None and prep.y_t is None
    scratch = sf.search_single(_t(x), _t(y), _t(y),
                               sf.gaussian_position_mask(H, W, PH, PW), PH,
                               PW, use_l2=True)
    cached = sf.search_single(_t(x), None, None, None, PH, PW, prep=prep,
                              use_l2=True)
    for a, b in zip(scratch, cached):
        assert torch.equal(a, b)
    cfg = Config({"use_L2andLAB": True})
    batch = _t(np.stack([x, y]))
    sf.reset_route_counts()
    served = sf.synthesize_side_image_prepped(batch, prep, PH, PW, cfg)
    direct = sf.synthesize_side_image(batch, _t(np.stack([y, y])),
                                      _t(np.stack([y, y])),
                                      sf.standard_prior(H, W, PH, PW), PH,
                                      PW, cfg)
    assert torch.equal(served, direct)
    assert torch.equal(served[0], scratch.y_syn)
    assert sf.route_counts == {"torch": 2, "tiled": 0, "kernel": 0}
    with pytest.raises(ValueError, match="Pearson-only"):
        sf.build_side_prep(_t(y), _t(y), PH, PW, use_l2=True,
                           for_kernel=True)
    with pytest.raises(ValueError, match="L2 prep for a Pearson search"):
        sf.search_single(_t(x), None, None, None, PH, PW, prep=prep)


@pytest.fixture(scope="module")
def l2_pair():
    ae, pc = tiny_configs()
    ae = ae.replace(use_L2andLAB=True)
    model = build_model(ae, pc, device="cpu", seed=3)
    left, right = make_stereo_pair(np.random.default_rng(3), 40, 56)
    x = left[None, :, :48].astype(np.float32)
    y = right[None, :, 8:].astype(np.float32)
    return ae, pc, model, x, y


def test_inference_step_with_l2_matches_jax(l2_pair):
    """`make_inference_step` at the tiny configuration (40x48, 20x24
    patches) with use_L2andLAB: symbols exact, images within 1e-3 of 255
    and bpp within rtol 1e-5 as in tests/test_torch_eval_path.py, with
    every patch's L2 margin beyond the distance bound."""
    ae, pc, model, x, y = l2_pair
    ph, pw = ae.y_patch_size
    mask = sf.gaussian_position_mask(40, 48, ph, pw)
    with torch.no_grad():
        x_dec = model.decode(model.encode(_t(x)).qbar)[0]
        y_dec = model.decode(model.encode(_t(y)).qbar)[0]
    res = sf.search_single(x_dec, _t(y[0]), y_dec, mask, ph, pw, use_l2=True)
    assert _margins(res.score_map) > 2e-5 * float(res.score_map.abs().max())
    got = port_step.make_inference_step(model, si_mask=mask)(x, y)
    params, stats = bridge.jax_from_state_dict(model.state_dict())
    jmodel = JaxDSIN(jax_parse_config(str(ae)), jax_parse_config(str(pc)))
    state = jax_step.TrainState(params=params, batch_stats=stats,
                                opt_state=(), step=jnp.int32(0))
    want = jax.device_get(jax_step.make_inference_step(
        jmodel, si_mask=jnp.asarray(mask))(state, x, y))
    np.testing.assert_array_equal(got["symbols"].numpy(), want["symbols"])
    for key in ("x_dec", "x_with_si", "y_syn"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=1e-3, err_msg=key)
    np.testing.assert_allclose(float(got["bpp"]), float(want["bpp"]),
                               rtol=1e-5)


def test_an_l2_session_serves(l2_pair):
    """`DeviceServer` with use_L2andLAB: an L2 prep without the kernel half,
    images in [0, 255], `with_scores` refused, and the session's search
    bit-equal to the from-scratch search on the same decoded images."""
    ae, pc, model, x, y = l2_pair
    server = DeviceServer(ae, pc, device="cpu", seed=3)
    prep = server.open_session(y[0])
    assert prep.sum_y2 is not None and prep.y_t is None
    symbols, _ = server.encode(x)
    out = server.decode_si(symbols, prep)
    assert out.shape == x.shape and float(out.min()) >= 0.0 \
        and float(out.max()) <= 255.0
    with pytest.raises(ValueError, match="with_scores is Pearson-only"):
        server.decode_si(symbols, prep, with_scores=True)
    ph, pw = ae.y_patch_size
    with torch.inference_mode():
        x_dec = server.model.decode(server.model.encode(_t(x)).qbar)
        y_dec = server.model.decode(server.model.encode(_t(y)).qbar)
        served = sf.synthesize_side_image_prepped(x_dec, prep, ph, pw, ae)
        scratch = sf.synthesize_side_image(
            x_dec, _t(y), y_dec, sf.standard_prior(40, 48, ph, pw), ph, pw,
            ae)
    assert torch.equal(served, scratch)
