"""The port's models against the JAX package on the same weights.

Tiny configuration (40x48 images, arch_param_B 2, 8 bottleneck channels),
weights from `DSIN.init_variables` with every batch-norm statistic, scale and
bias and the siNet kernels perturbed by seeded noise (so each mapping of
`bridge.py` is exercised), passed through the bridge and loaded strictly.

Tolerances: symbols and anything indexed by them are compared exactly; the
nets agree to float tolerance, because the port's fp32 convolutions sum in
another order than XLA's (atol given per test, relative to the scale of the
values compared).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsin_tpu.config import parse_config as jax_parse
from dsin_tpu.models import autoencoder as jax_ae
from dsin_tpu.models import probclass as jax_pc
from dsin_tpu.models import quantizer as jax_quant
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu_torch import bridge
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models import autoencoder as ae_lib
from dsin_tpu_torch.models import probclass as pc_lib
from dsin_tpu_torch.models import quantizer as quant_lib
from dsin_tpu_torch.models.dsin import build_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, H, W = 2, 40, 48


def _perturb(tree, rng, path=()):
    """Seeded noise on BN scale/bias/mean/var and siNet leaves."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _perturb(value, rng, path + (key,))
            continue
        value = np.array(value)
        if "BatchNorm_0" in path or "sinet" in path:
            noise = rng.normal(0, 0.1, value.shape).astype(np.float32)
            value = (value * np.exp(noise) if key == "var"
                     else value + noise)
        out[key] = value
    return out


@pytest.fixture(scope="module")
def models():
    ae, pc = tiny_configs(N)
    jmodel = JaxDSIN(jax_parse(str(ae)), jax_parse(str(pc)))
    variables = jmodel.init_variables(jax.random.PRNGKey(0), (N, H, W, 3))
    rng = np.random.default_rng(0)
    params = _perturb(jax.tree_util.tree_map(np.asarray, variables.params),
                      rng)
    stats = _perturb(jax.tree_util.tree_map(np.asarray,
                                            variables.batch_stats), rng)
    tmodel = build_model(ae, pc, device="cpu")
    tmodel.load_state_dict(bridge.state_dict_from_jax(params, stats),
                           strict=True)
    x = rng.uniform(0, 255, (N, H, W, 3)).astype(np.float32)
    return jmodel, params, stats, tmodel, x


def test_bridge_covers_the_whole_state_dict(models):
    _, params, stats, tmodel, _ = models
    sd = bridge.state_dict_from_jax(params, stats)
    assert set(sd) == set(tmodel.state_dict())
    for key, value in sd.items():
        assert value.shape == tmodel.state_dict()[key].shape, key


def test_quantizer_matches_jax():
    rng = np.random.default_rng(1)
    centers = np.sort(rng.uniform(-2, 2, 6)).astype(np.float32)
    z = rng.normal(0, 1.5, (4, 5, 6, 8)).astype(np.float32)
    mids = (centers[1:] + centers[:-1]) / 2
    assert np.abs(z[..., None] - mids).min() > 1e-4   # no ambiguous symbol
    jq = jax_quant.quantize(jnp.asarray(z), jnp.asarray(centers))
    tq = quant_lib.quantize(torch.from_numpy(z), torch.from_numpy(centers))
    np.testing.assert_array_equal(tq.symbols.numpy(), np.asarray(jq.symbols))
    np.testing.assert_array_equal(tq.qhard.numpy(), np.asarray(jq.qhard))
    # softmax over 6 centers: a few ulp apart between the two libraries
    np.testing.assert_allclose(tq.qsoft.numpy(), np.asarray(jq.qsoft),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tq.qbar.numpy(), np.asarray(jq.qbar),
                               rtol=1e-6, atol=1e-6)
    looked = quant_lib.centers_lookup(torch.from_numpy(centers), tq.symbols)
    np.testing.assert_array_equal(looked.numpy(), tq.qhard.numpy())


def test_encode_matches_jax(models):
    jmodel, params, stats, tmodel, x = models
    jout, _ = jax.jit(lambda p, s, a: jmodel.encode(p, s, a, train=False))(
        params, stats, x)
    with torch.no_grad():
        tout = tmodel.encode(torch.from_numpy(x))
    # z is O(1): 1e-4 absolute covers the conv summation order
    np.testing.assert_allclose(tout.z.numpy(), np.asarray(jout.z),
                               rtol=0, atol=1e-4)
    # the heatmap is sigmoid(b0) * C, C = 8: up to 8x the bottleneck's error
    np.testing.assert_allclose(tout.heatmap.numpy(),
                               np.asarray(jout.heatmap), rtol=0, atol=1e-4)
    centers = np.sort(params["centers"])
    mids = (centers[1:] + centers[:-1]) / 2
    z = np.asarray(jout.z)
    assert np.abs(z[..., None] - mids).min() > 1e-4, \
        "a z lies within 1e-4 of a centre midpoint: symbols ambiguous"
    np.testing.assert_array_equal(tout.symbols.numpy(),
                                  np.asarray(jout.symbols))


def test_decode_matches_jax(models):
    jmodel, params, stats, tmodel, x = models
    jenc, _ = jax.jit(lambda p, s, a: jmodel.encode(p, s, a, train=False))(
        params, stats, x)
    q = np.array(jenc.qbar)
    jdec, _ = jax.jit(lambda p, s, a: jmodel.decode(p, s, a, train=False))(
        params, stats, q)
    with torch.no_grad():
        tdec = tmodel.decode(torch.from_numpy(q))
    # pixels in [0, 255]: 2e-3 absolute is 1e-5 relative to the range
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), rtol=0,
                               atol=2e-3)


def test_bitcost_and_bpp_match_jax(models):
    jmodel, params, _, tmodel, x = models
    rng = np.random.default_rng(2)
    symbols = rng.integers(0, 6, (N, H // 8, W // 8, 8)).astype(np.int32)
    q = params["centers"][symbols]
    jbits = jax.jit(jmodel.bitcost)(params, q, symbols)
    with torch.no_grad():
        tbits = tmodel.bitcost(torch.from_numpy(q), torch.from_numpy(symbols))
    # bits per symbol O(1): small 3-D convs in float32
    np.testing.assert_allclose(tbits.numpy(), np.asarray(jbits), rtol=1e-5,
                               atol=1e-5)
    jbpp = jax_pc.bitcost_to_bpp(jbits, jnp.asarray(x))
    tbpp = pc_lib.bitcost_to_bpp(tbits, torch.from_numpy(x))
    np.testing.assert_allclose(float(tbpp), float(jbpp), rtol=1e-5)


def test_apply_sinet_matches_jax(models):
    jmodel, params, _, tmodel, x = models
    rng = np.random.default_rng(3)
    y_syn = rng.uniform(0, 255, x.shape).astype(np.float32)
    jout = jax.jit(jmodel.apply_sinet)(params, x, y_syn)
    with torch.no_grad():
        tout = tmodel.apply_sinet(torch.from_numpy(x),
                                  torch.from_numpy(y_syn))
    # nine dilated 32-channel convs with perturbed kernels, unclipped
    # output: 1e-5 of the output's own scale
    scale = float(np.abs(np.asarray(jout)).max())
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("include_center", [True, False])
@pytest.mark.parametrize("kernel_size", [3, 5])
def test_make_mask_equals_jax(kernel_size, include_center):
    np.testing.assert_array_equal(
        pc_lib.make_mask(kernel_size, include_center),
        jax_pc.make_mask(kernel_size, include_center))


def test_pad_volume_equals_jax():
    rng = np.random.default_rng(4)
    vol = rng.normal(size=(2, 8, 5, 6, 1)).astype(np.float32)
    jpad = jax_pc.pad_volume(jnp.asarray(vol), 3, 0.75)
    tpad = pc_lib.pad_volume(torch.from_numpy(vol).permute(0, 4, 1, 2, 3),
                             3, 0.75)
    np.testing.assert_array_equal(tpad.permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(jpad))


def test_heatmap_and_normalization_equal_jax():
    rng = np.random.default_rng(5)
    b = rng.normal(0, 3, (2, 5, 6, 9)).astype(np.float32)
    np.testing.assert_allclose(
        ae_lib.heatmap3d(torch.from_numpy(b)).numpy(),
        np.asarray(jax_ae.heatmap3d(jnp.asarray(b))), rtol=0, atol=1e-6)
    img = rng.uniform(0, 255, (2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ae_lib.normalize_image(torch.from_numpy(img), "FIXED").numpy(),
        np.asarray(jax_ae.normalize_image(jnp.asarray(img), "FIXED")))
    np.testing.assert_array_equal(
        ae_lib.denormalize_image(torch.from_numpy(img), "FIXED").numpy(),
        np.asarray(jax_ae.denormalize_image(jnp.asarray(img), "FIXED")))
