"""The port's patch search against the JAX package.

* the plain torch search (`sifinder_impl='torch'`) against the JAX XLA path;
* the kernel module: `pearson_argmax_reference` against the Pallas kernels
  run in interpret mode (`fused_pearson_argmax`, `fused_pearson_argmax_shared`)
  on identical numpy operands, and the kernel route end to end;
* cached preps against preps built from scratch.
On the CPU the kernel wrappers run their plain version, so the 'kernel'
route here exercises everything around the CUDA kernel.

Tolerances: scores are Pearson correlations times a prior in [0, 1], so
|score| <= 1; they agree to 1e-5 absolute (fp32 sums in another order).
Argmax indices must be equal wherever the top-two margin exceeds 1e-4
(asserted on the data, so equality is then required exactly); planted exact
copies must be found exactly; cached and scratch preps are bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsin_tpu.ops import color as jax_color
from dsin_tpu.ops import patches as jax_patches
from dsin_tpu.ops import sifinder as jsf
from dsin_tpu.ops import sifinder_pallas as jsp
from dsin_tpu_torch.config import Config
from dsin_tpu_torch.ops import color as color_lib
from dsin_tpu_torch.ops import patches as patches_lib
from dsin_tpu_torch.ops import sifinder as sf
from dsin_tpu_torch.ops import sifinder_kernel as sk
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, PH, PW = 24, 36, 8, 12
P = (H // PH) * (W // PW)
HC, WC = H - PH + 1, W - PW + 1
MARGIN = 1e-4


class _JaxCfg:
    def __init__(self, impl):
        self.use_L2andLAB = False
        self.sifinder_impl = impl
        self.sifinder_dtype = "float32"


def _cfg(impl):
    return Config({"use_L2andLAB": False, "sifinder_impl": impl})


def _rand_pair(seed, batch=2, h=H, w=W):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (batch, h, w, 3)).astype(np.float32)
    y = np.clip(x[:, ::-1] * 0.6 + rng.uniform(0, 255, x.shape) * 0.4,
                0, 255).astype(np.float32)
    return x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _margin(score_map):
    """Per-patch gap between the best and second-best score."""
    flat = np.sort(np.asarray(score_map).reshape(-1, score_map.shape[-1]), 0)
    return flat[-1] - flat[-2]


def test_color_and_patches_equal_jax():
    x, _ = _rand_pair(0)
    np.testing.assert_array_equal(
        color_lib.search_transform(_t(x)).numpy(),
        np.asarray(jax_color.search_transform(jnp.asarray(x), False)))
    jp = jax_patches.extract_patches(jnp.asarray(x[0]), PH, PW)
    tp = patches_lib.extract_patches(_t(x[0]), PH, PW)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(
        patches_lib.assemble_patches(tp, H, W).numpy(), x[0])


@pytest.mark.parametrize("shape", [(H, W, PH, PW), (40, 48, 20, 24),
                                   (320, 1224, 20, 24)])
def test_gaussian_factors_equal_jax(shape):
    for got, want in zip(sf.gaussian_position_mask_factors(*shape),
                         jsf.gaussian_position_mask_factors(*shape)):
        np.testing.assert_array_equal(got, want)


def test_gaussian_mask_and_its_detection():
    mask = sf.gaussian_position_mask(H, W, PH, PW)
    np.testing.assert_array_equal(
        mask, np.asarray(jsf.gaussian_position_mask(H, W, PH, PW)))
    assert sf.standard_mask_factors(mask, H, W, PH, PW) is not None
    assert sf.standard_mask_factors(_t(mask), H, W, PH, PW) is not None
    custom = mask.copy()
    custom[HC // 3, WC // 2, 5] *= 1.0001
    assert sf.standard_mask_factors(custom, H, W, PH, PW) is None


def test_window_statistics_match_jax():
    _, y = _rand_pair(1)
    r = color_lib.search_transform(_t(y[0]))
    jsum, jsum2 = jsf._window_sums(jnp.asarray(r.numpy()), PH, PW)
    tsum, tsum2 = sf.window_sums(r, PH, PW)
    np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(tsum2.numpy(), np.asarray(jsum2), rtol=1e-5)
    # the kernel's side prep: same layout, rsqrt-form denominator
    jy_t, jinv = jsp._side_from_transformed(jnp.asarray(r.numpy()), PH, PW,
                                            1e-12)
    ty_t, tinv = sk.side_from_transformed(r, PH, PW)
    np.testing.assert_array_equal(ty_t.numpy(), np.asarray(jy_t))
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=1e-5)


def test_query_prep_matches_jax():
    x, _ = _rand_pair(2)
    jpk = jsp._prepare_query(jnp.asarray(x[0]), PH, PW, 1e-12)
    tpk = sk.prepare_query(_t(x[:1]), PH, PW)[0]
    # unit-norm patches: entries O(0.1)
    np.testing.assert_allclose(tpk.numpy(), np.asarray(jpk), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("use_mask", [True, False])
def test_search_single_matches_jax(use_mask):
    x, y = _rand_pair(3)
    mask = sf.gaussian_position_mask(H, W, PH, PW) if use_mask else None
    ref = jsf.search_single(jnp.asarray(x[0]), jnp.asarray(y[0]),
                            jnp.asarray(y[0]),
                            None if mask is None else jnp.asarray(mask),
                            PH, PW, use_l2=False)
    got = sf.search_single(_t(x[0]), _t(y[0]), _t(y[0]), mask, PH, PW)
    np.testing.assert_allclose(got.score_map.numpy(),
                               np.asarray(ref.score_map), rtol=0, atol=1e-5)
    assert _margin(ref.score_map).min() > MARGIN
    np.testing.assert_array_equal(got.best_flat.numpy(),
                                  np.asarray(ref.best_flat))
    np.testing.assert_array_equal(got.y_syn.numpy(), np.asarray(ref.y_syn))
    np.testing.assert_allclose(got.best_score.numpy(),
                               np.asarray(ref.best_score), rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("use_mask", [True, False])
def test_synthesize_side_image_matches_jax(impl, use_mask):
    x, y = _rand_pair(4)
    mask = sf.gaussian_position_mask(H, W, PH, PW) if use_mask else None
    jmask = None if mask is None else jnp.asarray(mask)
    for i in range(x.shape[0]):
        ref = jsf.search_single(jnp.asarray(x[i]), jnp.asarray(y[i]),
                                jnp.asarray(y[i]), jmask, PH, PW,
                                use_l2=False)
        assert _margin(ref.score_map).min() > MARGIN
    want = jsf.synthesize_side_image(jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(y), jmask, PH, PW,
                                     _JaxCfg("xla"))
    got = sf.synthesize_side_image(_t(x), _t(y), _t(y), mask, PH, PW,
                                   _cfg(impl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pallas_operands(x, y, prior):
    preps = [jsp._prepare_single(jnp.asarray(a), jnp.asarray(b), PH, PW,
                                 1e-12) for a, b in zip(x, y)]
    y_t, pk, inv = (np.stack([np.asarray(p[i]) for p in preps])
                    for i in range(3))
    if prior:
        gh, gw = jsf.gaussian_position_mask_factors(H, W, PH, PW)
    else:
        gh, gw = (np.ones((HC, P), np.float32), np.ones((WC, P), np.float32))
    return y_t, pk, inv, gh, np.ascontiguousarray(gw.T)


@pytest.mark.parametrize("planted", [False, True])
def test_reference_matches_pallas_kernel(planted):
    """K1: the plain version against `fused_pearson_argmax` (interpret) on
    identical operands; planted copies (no prior) must match exactly."""
    x, y = _rand_pair(5)
    spots = []
    if planted:
        for b, (patch_idx, r0, c0) in enumerate([(4, 5, 9), (7, 0, 20)]):
            pr, pc = (patch_idx // (W // PW)) * PH, (patch_idx % (W // PW)) * PW
            y[b, r0:r0 + PH, c0:c0 + PW] = x[b, pr:pr + PH, pc:pc + PW]
            spots.append((b, patch_idx, r0 * WC + c0))
    ops = _pallas_operands(x, y, prior=not planted)
    jval, jidx = jsp.fused_pearson_argmax(*map(jnp.asarray, ops), ph=PH,
                                          pw=PW, interpret=True)
    tops = tuple(map(_t, ops))
    tval, tidx = sk.pearson_argmax(*tops, PH, PW)
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=0,
                               atol=1e-5)
    bad = sk.index_disagreements(tops, PH, PW, _t(jidx), tval, tidx, MARGIN)
    assert not bool(bad.any())
    for b, p, flat in spots:
        assert int(tidx[b, p]) == int(jidx[b, p]) == flat


def test_reference_matches_pallas_shared_kernel():
    """K2: `pearson_argmax_shared` (unpadded side operands) against
    `fused_pearson_argmax_shared` (interpret) on a JAX prep padded for it."""
    x, y = _rand_pair(6, batch=3)
    factors = jsf.gaussian_position_mask_factors(H, W, PH, PW)
    jprep = jsf.build_side_prep(jnp.asarray(y[0]), jnp.asarray(y[0]), PH, PW,
                                mask_factors=factors, for_pallas=True)
    pk = np.stack([np.asarray(jsp._prepare_query(jnp.asarray(a), PH, PW,
                                                 1e-12)) for a in x])
    jval, jidx = jsp.fused_pearson_argmax_shared(
        jprep.y_t_pad, jnp.asarray(pk), jprep.inv_denom_pad, jprep.gh_pad,
        jprep.gw_t_pad, ph=PH, pw=PW, hc=HC, wc=WC, interpret=True)
    y_t, inv = jsp._prepare_side(jnp.asarray(y[0]), PH, PW, 1e-12)
    side = (_t(y_t), _t(inv), _t(factors[0]),
            _t(np.ascontiguousarray(factors[1].T)))
    tval, tidx = sk.pearson_argmax_shared(side[0], _t(pk), side[1], side[2],
                                          side[3], PH, PW)
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=0,
                               atol=1e-5)
    batched = (side[0].expand(3, -1, -1, -1), _t(pk),
               side[1].expand(3, -1, -1), side[2], side[3])
    bad = sk.index_disagreements(batched, PH, PW, _t(jidx), tval, tidx,
                                 MARGIN)
    assert not bool(bad.any())


def test_tie_goes_to_the_lowest_flat_index():
    """Two exact copies of one x patch: the lower flat index wins, as with
    jnp.argmax (the JAX package's cross-tile tie case)."""
    h2, w2 = 16, 288
    wc2 = w2 - PW + 1
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 255, (1, h2, w2, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (1, h2, w2, 3)).astype(np.float32)
    patch_idx = 2
    pr, pc = (patch_idx // (w2 // PW)) * PH, (patch_idx % (w2 // PW)) * PW
    flat_a, flat_b = 200, wc2
    for flat in (flat_a, flat_b):
        r0, c0 = divmod(flat, wc2)
        y[0, r0:r0 + PH, c0:c0 + PW] = x[0, pr:pr + PH, pc:pc + PW]
    pk = sk.prepare_query(_t(x), PH, PW)
    y_t, inv = sk.side_from_transformed(
        color_lib.search_transform(_t(y[0])), PH, PW)
    p2 = pk.shape[1]
    _, idx = sk.pearson_argmax(y_t[None], pk, inv[None],
                               torch.ones(h2 - PH + 1, p2),
                               torch.ones(p2, wc2), PH, PW)
    assert int(idx[0, patch_idx]) == flat_a


def test_kernel_route_matches_pallas_route():
    """The whole kernel route (preps, search, gather) against the JAX
    package's Pallas route in interpret mode, with the prior."""
    x, y = _rand_pair(7)
    mask = sf.gaussian_position_mask(H, W, PH, PW)
    want = jsf.synthesize_side_image(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(y), jnp.asarray(mask),
        PH, PW, _JaxCfg("pallas_interpret"))
    got = sf.synthesize_side_image(_t(x), _t(y), _t(y), mask, PH, PW,
                                   _cfg("kernel"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("use_mask", [True, False])
def test_cached_prep_is_bit_identical_to_scratch(impl, use_mask):
    x, y = _rand_pair(8, batch=3)
    y_rep = np.repeat(y[:1], 3, axis=0)
    mask = sf.gaussian_position_mask(H, W, PH, PW) if use_mask else None
    factors = (sf.gaussian_position_mask_factors(H, W, PH, PW) if use_mask
               else None)
    scratch = sf.synthesize_side_image(_t(x), _t(y_rep), _t(y_rep), mask,
                                       PH, PW, _cfg(impl))
    prep = sf.build_side_prep(_t(y[0]), _t(y[0]), PH, PW,
                              mask_factors=factors,
                              for_kernel=impl == "kernel")
    cached = sf.synthesize_side_image_prepped(_t(x), prep, PH, PW,
                                              _cfg(impl))
    assert torch.equal(cached, scratch)


def test_prepped_search_matches_jax_prepped():
    x, y = _rand_pair(9, batch=2)
    factors = sf.gaussian_position_mask_factors(H, W, PH, PW)
    jprep = jsf.build_side_prep(jnp.asarray(y[0]), jnp.asarray(y[0]), PH, PW,
                                mask_factors=factors)
    want = jsf.synthesize_side_image_prepped(jnp.asarray(x), jprep, PH, PW,
                                             _JaxCfg("xla"))
    for impl in ("torch", "kernel"):
        prep = sf.build_side_prep(_t(y[0]), _t(y[0]), PH, PW,
                                  mask_factors=factors,
                                  for_kernel=impl == "kernel")
        got = sf.synthesize_side_image_prepped(_t(x), prep, PH, PW,
                                               _cfg(impl))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_auto_takes_the_plain_search_for_cpu_tensors():
    x, y = _rand_pair(10, batch=1)
    sk.reset_launch_counts()
    got = sf.synthesize_side_image(_t(x), _t(y), _t(y), None, PH, PW,
                                   _cfg("auto"))
    want = sf.synthesize_side_image(_t(x), _t(y), _t(y), None, PH, PW,
                                    _cfg("torch"))
    assert torch.equal(got, want)
    assert sk.launch_counts == {"pearson_argmax": 0,
                                "pearson_argmax_shared": 0}
