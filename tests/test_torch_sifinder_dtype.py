"""The `sifinder_dtype` knob in the port's patch search, against the JAX
package.

The knob rounds the correlation's two operands (the normalized x-hat patches
and the transformed side image) to bfloat16 or float16 and sums their
products in float32, on every route: the torch route's `_correlate` as JAX's
`_correlate` (`preferred_element_type=float32`), the kernel route's `pk` and
`y_t` as the Pallas kernel's `compute_dtype`. The input is the one that
showed the knob ignored: batch 2 at 40x48 with 8x12 patches, y a noisy flip
of x, x-hat = x + N(0, 4), no prior; there one of 40 patches of y_syn moved
by 191 of 255 when the port ran float32 under 'bfloat16'.

Tolerances: a product of two bfloat16 values is exact in float32, so the two
packages differ only in the order of the float32 sums. Argmax indices (and
the y_syn patch they pick) must be equal wherever JAX's top-two margin
exceeds 1e-4; scores agree to 1e-5 absolute (|score| <= 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsin_tpu.ops import sifinder as jsf
from dsin_tpu.ops import sifinder_pallas as jsp
from dsin_tpu_torch.config import Config
from dsin_tpu_torch.ops import sifinder as sf
from dsin_tpu_torch.ops import sifinder_kernel as sk
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, PH, PW = 40, 48, 8, 12
HC, WC = H - PH + 1, W - PW + 1
GRID = (H // PH, W // PW)
MARGIN = 1e-4


class _JaxCfg:
    def __init__(self, impl, dtype):
        self.use_L2andLAB = False
        self.sifinder_impl = impl
        self.sifinder_dtype = dtype


def _cfg(impl, dtype):
    return Config({"use_L2andLAB": False, "sifinder_impl": impl,
                   "sifinder_dtype": dtype})


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs():
    """(x_hat, y) of the reproduction: x from default_rng(3)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    y = np.clip(x[:, ::-1] * 0.6 + rng.uniform(0, 255, x.shape) * 0.4,
                0, 255).astype(np.float32)
    x_hat = (x + rng.normal(0, 4, x.shape)).astype(np.float32)
    return x_hat, y


def _jax_margins(x_hat, y, dtype):
    """(2, P) top-two margin of JAX's XLA score map under `dtype`."""
    out = []
    for a, b in zip(x_hat, y):
        scores = np.asarray(jsf.search_single(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(b), None, PH, PW,
            use_l2=False, conv_dtype=jnp.dtype(dtype)).score_map)
        flat = np.sort(scores.reshape(-1, scores.shape[-1]), 0)
        out.append(flat[-1] - flat[-2])
    return np.stack(out)


def _patch_diff(a, b):
    """(2, P) max |a - b| over each patch of two (2, H, W, 3) images."""
    d = np.abs(np.asarray(a) - np.asarray(b))
    return d.reshape(2, GRID[0], PH, GRID[1], PW, 3).max(
        axis=(2, 4, 5)).reshape(2, -1)


@pytest.mark.parametrize("value, want", [
    (None, torch.float32), ("float32", torch.float32),
    ("bfloat16", torch.bfloat16), ("float16", torch.float16)])
def test_the_knob_reads_as_jax_reads_it(value, want):
    assert sf.sifinder_conv_dtype(_cfg("torch", value)) == want
    if value is not None:
        assert jnp.dtype(value).name == str(want).replace("torch.", "")


def test_a_missing_knob_is_float32_and_a_bad_one_raises():
    assert sf.sifinder_conv_dtype(Config({})) == torch.float32
    for bad in ("bf16", "int8", "float64"):
        with pytest.raises(ValueError, match="sifinder_dtype"):
            sf.sifinder_conv_dtype(_cfg("torch", bad))
        with pytest.raises(ValueError, match="sifinder_dtype"):
            sf.synthesize_side_image(*map(_t, (*_inputs(), _inputs()[1])),
                                     None, PH, PW, _cfg("torch", bad))


def test_round_operand_is_a_cast_and_back():
    t = torch.from_numpy(np.random.default_rng(0).normal(
        size=(5, 7)).astype(np.float32))
    assert sf.round_operand(t, torch.float32) is t
    got = sf.round_operand(t, torch.bfloat16)
    assert got.dtype == torch.float32
    want = np.asarray(jnp.asarray(t.numpy()).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_search_matches_jax_xla_under_the_knob(impl, dtype):
    x_hat, y = _inputs()
    want = jsf.synthesize_side_image(jnp.asarray(x_hat), jnp.asarray(y),
                                     jnp.asarray(y), None, PH, PW,
                                     _JaxCfg("xla", dtype))
    got = sf.synthesize_side_image(_t(x_hat), _t(y), _t(y), None, PH, PW,
                                   _cfg(impl, dtype))
    clear = _jax_margins(x_hat, y, dtype) > MARGIN
    assert clear.sum() >= 38
    assert (_patch_diff(got, want)[clear] == 0).all()


def test_the_patch_that_moved_now_agrees():
    """Run at float32, the port's search picks another match than JAX's
    bfloat16 search on one patch (a near-tie under bfloat16, whose two
    candidates differ by more than 100 of 255); under the knob the port picks
    JAX's match there too."""
    x_hat, y = _inputs()
    want = jsf.synthesize_side_image(jnp.asarray(x_hat), jnp.asarray(y),
                                     jnp.asarray(y), None, PH, PW,
                                     _JaxCfg("xla", "bfloat16"))
    f32 = sf.synthesize_side_image(_t(x_hat), _t(y), _t(y), None, PH, PW,
                                   _cfg("torch", None))
    moved = _patch_diff(f32, want)
    assert (moved > 0).sum() == 1 and moved.max() > 100
    got = sf.synthesize_side_image(_t(x_hat), _t(y), _t(y), None, PH, PW,
                                   _cfg("torch", "bfloat16"))
    assert (_patch_diff(got, want)[moved > 0] == 0).all()


def test_float32_knob_is_the_knob_unset():
    x_hat, y = _inputs()
    for impl in ("torch", "kernel"):
        unset = sf.synthesize_side_image(_t(x_hat), _t(y), _t(y), None, PH,
                                         PW, _cfg(impl, None))
        f32 = sf.synthesize_side_image(_t(x_hat), _t(y), _t(y), None, PH,
                                       PW, _cfg(impl, "float32"))
        assert torch.equal(unset, f32)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_prepped_search_matches_jax_prepped_under_the_knob(impl):
    x_hat, y = _inputs()
    jprep = jsf.build_side_prep(jnp.asarray(y[0]), jnp.asarray(y[0]), PH, PW)
    want = jsf.synthesize_side_image_prepped(
        jnp.asarray(x_hat), jprep, PH, PW, _JaxCfg("xla", "bfloat16"))
    prep = sf.build_side_prep(_t(y[0]), _t(y[0]), PH, PW,
                              for_kernel=impl == "kernel",
                              conv_dtype=torch.bfloat16)
    got = sf.synthesize_side_image_prepped(_t(x_hat), prep, PH, PW,
                                           _cfg(impl, "bfloat16"))
    y_rep = np.repeat(y[:1], 2, axis=0)
    clear = _jax_margins(x_hat, y_rep, "bfloat16") > MARGIN
    assert clear.sum() >= 38
    assert (_patch_diff(got, want)[clear] == 0).all()


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_a_prep_of_another_dtype_raises(impl):
    x_hat, y = _inputs()
    prep = sf.build_side_prep(_t(y[0]), _t(y[0]), PH, PW,
                              for_kernel=impl == "kernel")
    assert prep.conv_dtype == torch.float32
    with pytest.raises(sf.PrepDtypeMismatch, match="bfloat16"):
        sf.synthesize_side_image_prepped(_t(x_hat), prep, PH, PW,
                                         _cfg(impl, "bfloat16"))
    assert issubclass(sf.PrepDtypeMismatch, ValueError)


def test_kernel_prep_rounds_only_the_correlation_operand():
    _, y = _inputs()
    f32 = sf.build_side_prep(_t(y[0]), _t(y[0]), PH, PW, for_kernel=True)
    bf16 = sf.build_side_prep(_t(y[0]), _t(y[0]), PH, PW, for_kernel=True,
                              conv_dtype=torch.bfloat16)
    assert bf16.y_t.dtype == torch.float32
    assert torch.equal(bf16.y_t, sf.round_operand(f32.y_t, torch.bfloat16))
    assert not torch.equal(bf16.y_t, f32.y_t)
    for name in ("inv_denom", "r_img", "inv_window_std"):
        assert torch.equal(getattr(bf16, name), getattr(f32, name))


def test_rounded_operands_through_the_plain_kernel_match_pallas_bf16():
    """K1's plain version on bfloat16-rounded `pk` and `y_t` (float32
    tensors) against `fused_pearson_argmax` in interpret mode on the same
    operands cast to bfloat16."""
    x_hat, y = _inputs()
    preps = [jsp._prepare_single(jnp.asarray(a), jnp.asarray(b), PH, PW,
                                 1e-12) for a, b in zip(x_hat, y)]
    y_t, pk, inv = (np.stack([np.asarray(p[i]) for p in preps])
                    for i in range(3))
    gh, gw = jsf.gaussian_position_mask_factors(H, W, PH, PW)
    gw_t = np.ascontiguousarray(gw.T)
    jval, jidx = jsp.fused_pearson_argmax(
        jnp.asarray(y_t).astype(jnp.bfloat16),
        jnp.asarray(pk).astype(jnp.bfloat16), jnp.asarray(inv),
        jnp.asarray(gh), jnp.asarray(gw_t), ph=PH, pw=PW, interpret=True)
    ops = (sf.round_operand(_t(y_t), torch.bfloat16),
           sf.round_operand(_t(pk), torch.bfloat16), _t(inv), _t(gh),
           _t(gw_t))
    tval, tidx = sk.pearson_argmax(*ops, PH, PW)
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=0,
                               atol=1e-5)
    bad = sk.index_disagreements(ops, PH, PW, _t(jidx), tval, tidx, MARGIN)
    assert not bool(bad.any())


def test_kernel_route_matches_pallas_route_under_the_knob():
    """The port's kernel route (its plain version on the CPU) against the
    JAX package's Pallas route in interpret mode, both under 'bfloat16'."""
    x_hat, y = _inputs()
    want = jsf.synthesize_side_image(
        jnp.asarray(x_hat), jnp.asarray(y), jnp.asarray(y), None, PH, PW,
        _JaxCfg("pallas_interpret", "bfloat16"))
    got = sf.synthesize_side_image(_t(x_hat), _t(y), _t(y), None, PH, PW,
                                   _cfg("kernel", "bfloat16"))
    clear = _jax_margins(x_hat, y, "bfloat16") > MARGIN
    assert (_patch_diff(got, want)[clear] == 0).all()
