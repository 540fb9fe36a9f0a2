"""The port's fused decode epilogue (K4's fold and plain version) against the
JAX package's `ops/epilogue_pallas.py`.

Weights: the tiny configuration's decoder from the JAX package's
`DSIN.init_variables`, its final batch norm perturbed by seeded noise so that
every term of the fold counts, carried over by `bridge.state_dict_from_jax`.

Bounds: the folds are bit-equal (both run the same numpy float32 arithmetic
on the same values); the plain version agrees with the JAX reference and the
Pallas kernel in interpret mode within rtol 1e-5 and atol 1e-3 in [0, 255]
pixel units, as tests/test_epilogue_pallas.py:32 allows between them (the
KITTI denormalization scales the conv output by about 75, so float32
summation-order slack lands near 1e-4). With bfloat16 operands the plain
version widens them to float32 and sums exact products in float32, as the
Pallas kernel does with `preferred_element_type`; so the same bound holds
against the Pallas kernel run on bfloat16 inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsin_tpu.config import parse_config as jax_parse
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu.ops import epilogue_pallas as jax_epi
from dsin_tpu_torch import bridge
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models import autoencoder as ae_lib
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops import color as color_lib
from dsin_tpu_torch.ops import epilogue as epi_lib
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-3
FUZZ_SHAPES = [(1, 6, 12), (2, 5, 9), (1, 7, 16)]


@pytest.fixture(scope="module")
def decoders():
    """(JAX decoder params, JAX decoder stats, port decoder)."""
    ae, pc = tiny_configs(1)
    jmodel = JaxDSIN(jax_parse(str(ae)), jax_parse(str(pc)))
    variables = jmodel.init_variables(jax.random.PRNGKey(3), (1, 40, 48, 3))
    params = jax.tree_util.tree_map(np.asarray, variables.params)
    stats = jax.tree_util.tree_map(np.array, variables.batch_stats)
    rng = np.random.default_rng(3)
    bn = params["decoder"]["_ConvBN_2"]["BatchNorm_0"]
    bn_stats = stats["decoder"]["_ConvBN_2"]["BatchNorm_0"]
    bn["scale"] = bn["scale"] + rng.normal(0, 0.1, 3).astype(np.float32)
    bn["bias"] = bn["bias"] + rng.normal(0, 0.1, 3).astype(np.float32)
    bn_stats["mean"] = rng.normal(0, 0.1, 3).astype(np.float32)
    bn_stats["var"] = np.exp(rng.normal(0, 0.2, 3)).astype(np.float32)
    model = build_model(ae, pc, device="cpu")
    model.load_state_dict(bridge.state_dict_from_jax(params, stats),
                          strict=True)
    return params["decoder"], stats["decoder"], model.decoder


def _x_pre(cin, n, h2, w2, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=scale, size=(n, h2, w2, cin)).astype(np.float32)


@pytest.mark.parametrize("norm", ["FIXED", "OFF"])
def test_fold_is_bit_equal_to_jax(decoders, norm):
    jparams, jstats, decoder = decoders
    want = jax_epi.fold_epilogue_params(jparams, jstats, norm)
    got = epi_lib.fold_epilogue_params(decoder, norm)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_fold_refuses_an_unknown_normalization(decoders):
    with pytest.raises(ValueError, match="normalization"):
        epi_lib.fold_epilogue_params(decoders[2], "WAT")


@pytest.mark.parametrize("shape", FUZZ_SHAPES)
def test_plain_matches_jax_reference_and_pallas(decoders, shape):
    jparams, jstats, decoder = decoders
    jepi = jax_epi.fold_epilogue_params(jparams, jstats, "FIXED")
    epi = epi_lib.fold_epilogue_params(decoder, "FIXED")
    x = _x_pre(epi.wmat.shape[0] // 25, *shape, seed=sum(shape))
    img, srch = epi_lib.fused_decode_epilogue(torch.from_numpy(x), *epi)
    n, h2, w2 = shape
    assert tuple(img.shape) == tuple(srch.shape) == (n, 2 * h2, 2 * w2, 3)
    assert img.dtype == srch.dtype == torch.float32
    for fn in (jax_epi.epilogue_reference,
               lambda *a: jax_epi.fused_decode_epilogue(*a, interpret=True)):
        ref_img, ref_srch = fn(jnp.asarray(x), *jepi)
        np.testing.assert_allclose(img.numpy(), np.asarray(ref_img),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(srch.numpy(), np.asarray(ref_srch),
                                   rtol=RTOL, atol=ATOL)


def test_plain_matches_the_ports_decoder_tail(decoders):
    """The plain version against the port's own `decoder.conv2` (flipped
    `conv_transpose2d` + crop + BN), float32 cast, denormalization and clip;
    the search twin IS the search transform of that image."""
    _, _, decoder = decoders
    epi = epi_lib.fold_epilogue_params(decoder, "FIXED")
    x = torch.from_numpy(_x_pre(epi.wmat.shape[0] // 25, 2, 6, 12, seed=21))
    with torch.no_grad():
        tail = decoder.conv2(x.permute(0, 3, 1, 2)).float()
    tail = torch.clamp(ae_lib.denormalize_image(tail.permute(0, 2, 3, 1),
                                                "FIXED"), 0.0, 255.0)
    img, srch = epi_lib.fused_decode_epilogue(x, *epi)
    torch.testing.assert_close(img, tail, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(srch, color_lib.search_transform(tail),
                               rtol=1e-4, atol=ATOL)


def test_clip_hits_both_rails(decoders):
    jparams, jstats, decoder = decoders
    epi = epi_lib.fold_epilogue_params(decoder, "FIXED")
    x = _x_pre(epi.wmat.shape[0] // 25, 1, 6, 12, seed=9, scale=50.0)
    img, srch = epi_lib.fused_decode_epilogue(torch.from_numpy(x), *epi)
    assert float(img.min()) == 0.0 and float(img.max()) == 255.0
    torch.testing.assert_close(srch, color_lib.search_transform(img),
                               rtol=1e-4, atol=ATOL)
    ref_img, _ = jax_epi.fused_decode_epilogue(
        jnp.asarray(x), *jax_epi.fold_epilogue_params(jparams, jstats,
                                                      "FIXED"),
        interpret=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", FUZZ_SHAPES)
def test_bf16_operands_match_pallas_on_bf16_inputs(decoders, shape):
    jparams, jstats, decoder = decoders
    jepi = jax_epi.fold_epilogue_params(jparams, jstats, "FIXED")
    epi = epi_lib.fold_epilogue_params(decoder, "FIXED")
    x = _x_pre(epi.wmat.shape[0] // 25, *shape, seed=7 + sum(shape))
    xb = torch.from_numpy(x).bfloat16()
    img, srch = epi_lib.fused_decode_epilogue(xb, epi.wmat.bfloat16(),
                                              *epi[1:])
    assert img.dtype == torch.float32
    ref_img, ref_srch = jax_epi.fused_decode_epilogue(
        jnp.asarray(x, jnp.bfloat16), jepi.wmat.astype(jnp.bfloat16),
        *jepi[1:], interpret=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(srch.numpy(), np.asarray(ref_srch), rtol=RTOL,
                               atol=ATOL)
    # the bfloat16 operands are widened, not re-rounded: the same values in
    # float32 give the same images
    f32 = epi_lib.fused_decode_epilogue(xb.float(), epi.wmat.bfloat16()
                                        .float(), *epi[1:])
    assert torch.equal(img, f32[0]) and torch.equal(srch, f32[1])


def _epi(cin=4, dtype=torch.float32, device="cpu"):
    z = dict(dtype=torch.float32, device=device)
    return epi_lib.EpilogueParams(
        torch.zeros((25 * cin, 3), dtype=dtype, device=device),
        torch.ones((1, 3), **z), torch.zeros((1, 3), **z),
        torch.eye(3, **z), torch.zeros((1, 3), **z))


@pytest.mark.parametrize("x_shape,x_dtype,w_dtype,w_rows,exc,match", [
    ((1, 3, 4, 4), torch.float16, torch.float16, 100, TypeError,
     "float32 or bfloat16"),
    ((1, 3, 4, 4), torch.float32, torch.bfloat16, 100, TypeError,
     "both of one dtype"),
    ((1, 3, 4, 129), torch.float32, torch.float32, 25 * 129, ValueError,
     "Cin"),
    ((1, 3, 4), torch.float32, torch.float32, 100, ValueError, "NHWC"),
    ((1, 3, 4, 4), torch.float32, torch.float32, 24, ValueError,
     "wmat has shape"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(
        x_shape, x_dtype, w_dtype, w_rows, exc, match):
    epi = _epi()._replace(wmat=torch.zeros((w_rows, 3), dtype=w_dtype))
    with pytest.raises(exc, match=match):
        epi_lib.fused_decode_epilogue(torch.zeros(x_shape, dtype=x_dtype),
                                      *epi)


def test_non_cpu_tensors_never_reach_the_plain_version(monkeypatch):
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises (here: 'meta' tensors raise before any launch), and
    the plain version never counts a launch."""
    def refuse(*_):
        raise AssertionError("a non-CPU tensor reached the plain version")

    epi_lib.reset_launch_counts()
    epi_lib.fused_decode_epilogue(torch.zeros((1, 3, 4, 4)), *_epi())
    assert epi_lib.launch_counts == {"fused_decode_epilogue": 0}
    monkeypatch.setattr(epi_lib, "epilogue_reference", refuse)
    with pytest.raises(ValueError, match="CUDA tensors"):
        epi_lib.fused_decode_epilogue(
            torch.zeros((1, 3, 4, 4), device="meta"), *_epi(device="meta"))
    assert epi_lib.launch_counts == {"fused_decode_epilogue": 0}
