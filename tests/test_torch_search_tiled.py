"""The port's row-tiled Pearson search, its winning scores and the search
dispatch, against the JAX package.

Inputs: 40x48 images with 8x12 patches (Hc = 33 map rows, which none of the
row chunks 4, 7 and 64 divides, so the last chunk is padded and its rows
past Hc are forced to -inf), x uniform from a seeded numpy generator and
y = x + N(0, 8), so every patch's best match stands clear of the runner-up.

Bounds: indices are exact where the top-two margin exceeds 1e-4 (checked
here for every patch on the port's materialized map, beyond the 1e-5 the
two packages' scores may differ by, so no float32 summation order can flip
them); the winning scores agree within 1e-5 absolute (Pearson scores lie
in [-1, 1]; XLA and oneDNN sum the correlation's 288 products in other
orders). The
port's tiled search against its own materialized search, and a cached prep
against a from-scratch one, are bit-identical: the same operations on the
same values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsin_tpu.ops import sifinder as jsf
from dsin_tpu_torch.config import Config
from dsin_tpu_torch.ops import sifinder as sf
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, PH, PW = 40, 48, 8, 12
P = (H // PH) * (W // PW)
MARGIN, SCORE_ATOL = 1e-4, 1e-5


class _JaxCfg:
    def __init__(self, impl, row_chunk=None):
        self.use_L2andLAB = False
        self.sifinder_impl = impl
        self.sifinder_row_chunk = row_chunk


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(40)
    x = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 8, x.shape), 0, 255).astype(np.float32)
    mask = sf.gaussian_position_mask(H, W, PH, PW)
    priors = {"factors": (sf.gaussian_position_mask_factors(H, W, PH, PW),
                          None),
              "custom": (None, mask * 0.5 + 0.25),   # not the standard prior
              "none": (None, None)}
    for factors, custom in priors.values():
        full = mask if factors is not None else custom
        for xi, yi in zip(x, y):
            score = sf.search_single(_t(xi), _t(yi), _t(yi), full, PH,
                                     PW).score_map
            top = torch.topk(score.reshape(-1, P), 2, dim=0).values
            assert float((top[0] - top[1]).min()) > MARGIN + SCORE_ATOL
    return dict(x=x, y=y, priors=priors)


@pytest.mark.parametrize("prior", ["factors", "custom", "none"])
@pytest.mark.parametrize("row_chunk", [4, 7, 64])
def test_tiled_search_matches_jax(data, row_chunk, prior):
    factors, custom = data["priors"][prior]
    x, y = data["x"][0], data["y"][0]
    want = jsf.search_single_tiled(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(y), PH, PW,
        mask_factors=factors,
        mask=None if custom is None else jnp.asarray(custom),
        row_chunk=row_chunk)
    got = sf.search_single_tiled(_t(x), _t(y), _t(y), PH, PW,
                                 mask_factors=factors, mask=custom,
                                 row_chunk=row_chunk)
    assert got.score_map is None
    np.testing.assert_array_equal(got.best_flat.numpy(),
                                  np.asarray(want.best_flat))
    np.testing.assert_array_equal(got.y_syn.numpy(), np.asarray(want.y_syn))
    np.testing.assert_allclose(got.best_score.numpy(),
                               np.asarray(want.best_score), rtol=0,
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("prior", ["factors", "custom", "none"])
def test_tiled_search_matches_the_materialized_one(data, prior):
    """Indices and winning scores bit-equal to `search_single` (the prior
    as factors multiplies the same float32 product the mask holds)."""
    factors, custom = data["priors"][prior]
    x, y = _t(data["x"][0]), _t(data["y"][0])
    full = (sf.gaussian_position_mask(H, W, PH, PW) if factors is not None
            else custom)
    want = sf.search_single(x, y, y, full, PH, PW)
    for row_chunk in (4, 7, 64):
        got = sf.search_single_tiled(x, y, y, PH, PW, mask_factors=factors,
                                     mask=custom, row_chunk=row_chunk)
        assert torch.equal(got.best_flat, want.best_flat)
        assert torch.equal(got.best_score, want.best_score)
        assert torch.equal(got.y_syn, want.y_syn)


def test_prepped_tiled_search_is_bit_identical_to_scratch(data):
    x, y = _t(data["x"][1]), _t(data["y"][1])
    factors = data["priors"]["factors"][0]
    prep = sf.build_side_prep(y, y, PH, PW, mask_factors=factors)
    scratch = sf.search_single_tiled(x, y, y, PH, PW, mask_factors=factors,
                                     row_chunk=7)
    cached = sf.search_single_tiled(x, None, None, PH, PW, prep=prep,
                                    row_chunk=7)
    for a, b in zip(scratch, cached):
        assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError, match="prep OR"):
        sf.search_single_tiled(x, None, None, PH, PW, prep=prep,
                               mask_factors=factors)


@pytest.mark.parametrize("impl,jax_impl", [("torch", "xla"),
                                           ("tiled", "xla_tiled")])
def test_with_scores_matches_jax(data, impl, jax_impl):
    """`synthesize_side_image_prepped(with_scores=True)`: y_syn bit-equal
    with the flag on and off, equal to JAX's, and the winning scores within
    1e-5 of JAX's."""
    x, y = data["x"], data["y"][0]
    factors = data["priors"]["factors"][0]
    prep = sf.build_side_prep(_t(y), _t(y), PH, PW, mask_factors=factors)
    cfg = Config({"use_L2andLAB": False, "sifinder_impl": impl,
                  "sifinder_row_chunk": 7})
    sf.reset_route_counts()
    plain = sf.synthesize_side_image_prepped(_t(x), prep, PH, PW, cfg)
    y_syn, scores = sf.synthesize_side_image_prepped(_t(x), prep, PH, PW,
                                                     cfg, with_scores=True)
    assert sf.route_counts[impl] == 2
    assert torch.equal(plain, y_syn) and scores.shape == (2, P)
    jprep = jsf.build_side_prep(jnp.asarray(y), jnp.asarray(y), PH, PW,
                                mask_factors=factors)
    want_syn, want_scores = jsf.synthesize_side_image_prepped(
        jnp.asarray(x), jprep, PH, PW, _JaxCfg(jax_impl, 7),
        with_scores=True)
    np.testing.assert_array_equal(y_syn.numpy(), np.asarray(want_syn))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               rtol=0, atol=SCORE_ATOL)


def test_the_tiled_route_through_the_dispatch(data):
    """`sifinder_impl = 'tiled'` from scratch, the prior as a raw mask
    (checked to factors), as a `standard_prior` and as a custom mask:
    y_syn equal to the JAX package's 'xla_tiled' route."""
    x, y = data["x"], data["y"]
    cfg = Config({"use_L2andLAB": False, "sifinder_impl": "tiled",
                  "sifinder_row_chunk": 4})
    mask = sf.gaussian_position_mask(H, W, PH, PW)
    custom = data["priors"]["custom"][1]
    sf.reset_route_counts()
    for priors, jax_mask in (((mask, sf.standard_prior(H, W, PH, PW)), mask),
                             ((custom,), custom)):
        want = jsf.synthesize_side_image(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(y),
            jnp.asarray(jax_mask), PH, PW, _JaxCfg("xla_tiled", 4))
        for prior in priors:
            got = sf.synthesize_side_image(_t(x), _t(y), _t(y), prior, PH,
                                           PW, cfg)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sf.route_counts == {"torch": 0, "tiled": 3, "kernel": 0}


# -- the dispatch table ------------------------------------------------------

ROUTES = [
    # impl, device, l2, prior, kernel_half, with_scores -> route
    ("auto", "cuda", False, "none", True, False, "kernel"),
    ("auto", "cuda", False, "standard", True, False, "kernel"),
    ("auto", "cuda", False, "custom", True, False, "tiled"),
    ("auto", "cuda", True, "standard", True, False, "torch"),
    ("auto", "cuda", False, "standard", False, False, "torch"),
    ("auto", "cuda", False, "standard", True, True, "torch"),
    ("auto", "cpu", False, "custom", True, False, "torch"),
    ("auto", "cpu", False, "standard", True, False, "torch"),
    ("torch", "cuda", True, "custom", True, False, "torch"),
    ("tiled", "cpu", False, "custom", True, True, "tiled"),
    ("kernel", "cpu", False, "standard", True, False, "kernel"),
]


@pytest.mark.parametrize("impl,device,l2,prior,half,scores,route", ROUTES)
def test_route_table(impl, device, l2, prior, half, scores, route):
    assert sf.choose_route(impl, device, l2=l2, prior=prior,
                           kernel_half=half, with_scores=scores) == route


REFUSALS = [
    # impl, l2, prior, kernel_half, with_scores, message
    ("kernel", False, "custom", True, False, "standard"),
    ("kernel", False, "standard", True, True, "cannot return match scores"),
    ("kernel", False, "standard", False, False, "for_kernel=True"),
    ("kernel", True, "none", True, False, "Pearson-only"),
    ("tiled", True, "standard", True, False, "Pearson-only"),
    ("auto", True, "standard", True, True, "with_scores is Pearson-only"),
    ("torch", True, "none", True, True, "with_scores is Pearson-only"),
    ("pallas", False, "none", True, False, "expected one of"),
]


@pytest.mark.parametrize("impl,l2,prior,half,scores,message", REFUSALS)
def test_route_refusals(impl, l2, prior, half, scores, message):
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match=message):
            sf.choose_route(impl, device, l2=l2, prior=prior,
                            kernel_half=half, with_scores=scores)


def test_config_refusals_and_the_row_chunk_knob(data):
    for impl in ("tiled", "kernel"):
        with pytest.raises(ValueError, match="Pearson-only; use 'torch'"):
            sf.sifinder_impl(Config({"use_L2andLAB": True,
                                     "sifinder_impl": impl}))
    for value, want in ((None, 32), (0, 32), (16, 16)):
        cfg = Config({"sifinder_row_chunk": value})
        assert sf.sifinder_row_chunk(cfg) == want
    assert sf.sifinder_row_chunk(Config({})) == 32
    x, y = _t(data["x"][:1]), _t(data["y"][0])
    l2_prep = sf.build_side_prep(y, y, PH, PW, use_l2=True)
    with pytest.raises(ValueError, match="with_scores is Pearson-only"):
        sf.synthesize_side_image_prepped(
            x, l2_prep, PH, PW, Config({"use_L2andLAB": True}),
            with_scores=True)
    with pytest.raises(ValueError, match="Pearson-only"):
        sf.synthesize_side_image_prepped(
            x, l2_prep, PH, PW, Config({"sifinder_impl": "tiled"}))
    prep = sf.build_side_prep(y, y, PH, PW)
    with pytest.raises(ValueError, match="cannot return match scores"):
        sf.synthesize_side_image_prepped(
            x, prep, PH, PW, Config({"sifinder_impl": "kernel"}),
            with_scores=True)
