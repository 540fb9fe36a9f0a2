"""The port's precision ladder against the JAX package's.

Tiny configuration (40x48 images, arch_param_B 2, 8 bottleneck channels),
weights from the JAX package's `DSIN.init_variables` with every batch-norm
statistic, scale and bias and the siNet leaves perturbed by seeded noise,
carried over by `bridge.state_dict_from_jax`.

Bounds, each with its reason:
  * the rung casts are bit-identical to `PrecisionPolicy.cast_params`
    (the same numpy float32 fake-quant, the same round-to-nearest-even into
    bfloat16);
  * per-stage dtypes at the bf16 rung are equal to the JAX package's;
  * one ConvBN from equal bfloat16 inputs: within 4 bfloat16 ulps, and at
    most 0.1% of the outputs differ at all (the convs sum in another order,
    which moves a rounding to bfloat16 by one ulp now and then, and the BN
    affine can carry it);
  * whole nets at the bf16 and int8 rungs: 17 bfloat16 convs in a row
    compound those one-ulp differences (bfloat16 keeps 8 significant bits,
    0.4% relative), so the encoder's bottleneck and z agree within 4% of
    their largest magnitude, the decoder within 2 of [0, 255], siNet within
    2% of its output's scale;
  * symbols are equal wherever the JAX package's z lies further than
    `SYMBOL_MARGIN` (above the largest z difference of the run) from a
    quantizer decision boundary;
  * streams are compared byte for byte.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsin_tpu.coding import codec as jax_codec
from dsin_tpu.coding import precision as jax_precision
from dsin_tpu.config import parse_config as jax_parse
from dsin_tpu.models import autoencoder as jax_ae
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu_torch import bridge
from dsin_tpu_torch.coding import loader
from dsin_tpu_torch.coding import precision as precision_lib
from dsin_tpu_torch.coding.precision import (PrecisionError, PrecisionPolicy,
                                             check_entropy_critical)
from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models import autoencoder as ae_lib
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.runtime import config_path
from dsin_tpu_torch.serve.device import DeviceServer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 2, 40, 48
CAST_RUNGS = ("bf16", "int8")
Z_REL = 0.04           # of max|z| and max|bottleneck|
DECODE_ATOL = 2.0      # pixel units in [0, 255]
SINET_REL = 0.02       # of the siNet output's max magnitude
SYMBOL_MARGIN = 0.25   # above the largest |z - z_jax| (checked)
CONVBN_ULPS = 4


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


def _tiny(compute_dtype=None):
    ae, pc = tiny_configs(N)
    if compute_dtype is not None:
        ae = ae.replace(compute_dtype=compute_dtype)
    return ae, pc


@pytest.fixture(scope="module")
def weights():
    """The JAX tree (f32 params, batch stats) every test bridges from."""
    ae, pc = _tiny()
    jmodel = JaxDSIN(jax_parse(str(ae)), jax_parse(str(pc)))
    variables = jmodel.init_variables(jax.random.PRNGKey(0), (N, H, W, 3))
    rng = np.random.default_rng(0)
    params = _perturb(jax.tree_util.tree_map(np.asarray, variables.params),
                      rng)
    stats = _perturb(jax.tree_util.tree_map(np.asarray,
                                            variables.batch_stats), rng)
    x = rng.uniform(0, 255, (N, H, W, 3)).astype(np.float32)
    return params, stats, x


def _port(params, stats, compute_dtype=None, rung="fp32"):
    ae, pc = _tiny(compute_dtype)
    model = build_model(ae, pc, device="cpu")
    model.load_state_dict(bridge.state_dict_from_jax(params, stats),
                          strict=True)
    return PrecisionPolicy(rung).cast_model(model)


def _jax(params, compute_dtype=None, rung="fp32"):
    ae, pc = _tiny(compute_dtype)
    jmodel = JaxDSIN(jax_parse(str(ae)), jax_parse(str(pc)))
    return jmodel, jax_precision.PrecisionPolicy(rung).cast_params(params)


@pytest.fixture(scope="module", params=CAST_RUNGS)
def rung_pair(request, weights):
    """(rung, JAX model, JAX cast params, port model) at a cast rung."""
    params, stats, _ = weights
    jmodel, jparams = _jax(params, "bfloat16", request.param)
    return (request.param, jmodel, jparams,
            _port(params, stats, "bfloat16", request.param))


# -- the casts ---------------------------------------------------------------

@pytest.mark.parametrize("rung", CAST_RUNGS)
def test_casts_are_bit_identical_to_jax(weights, rung):
    params, stats, _ = weights
    port = _port(params, stats, rung=rung)
    want = bridge.state_dict_from_jax(
        jax_precision.PrecisionPolicy(rung).cast_params(params), stats)
    for name, param in port.named_parameters():
        part = name.split(".")[0]
        expect = (torch.bfloat16 if part in precision_lib.DISTORTION_SIDE
                  else torch.float32)
        assert param.dtype == expect, name
        # the bridge widens the JAX bfloat16 leaves to float32 exactly
        assert torch.equal(param.float(), want[name]), name
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert buf.dtype == torch.float32, name        # BN statistics
            assert torch.equal(buf, want[name]), name


@pytest.mark.parametrize("rung", CAST_RUNGS)
def test_entropy_critical_parameters_are_the_same_objects(rung):
    ae, pc = _tiny()
    model = build_model(ae, pc, device="cpu")
    before = {n: (p, p.data_ptr()) for n, p in model.named_parameters()
              if n.split(".")[0] in precision_lib.ENTROPY_CRITICAL}
    PrecisionPolicy(rung).cast_model(model)
    after = {n: p for n, p in model.named_parameters()
             if n.split(".")[0] in precision_lib.ENTROPY_CRITICAL}
    assert set(before) == set(after) and "centers" in after
    for name, (param, ptr) in before.items():
        assert after[name] is param and param.data_ptr() == ptr, name
        assert param.dtype == torch.float32, name
    check_entropy_critical(model)


def test_fp32_rung_leaves_the_model_as_it_is():
    ae, pc = _tiny()
    model = build_model(ae, pc, device="cpu")
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    PrecisionPolicy("fp32").cast_model(model)
    assert {n: p.data_ptr() for n, p in model.named_parameters()} == ptrs
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_unknown_rung_and_partition_are_refused():
    with pytest.raises(PrecisionError, match="unknown precision rung"):
        PrecisionPolicy("fp16")
    ae, pc = _tiny()
    model = build_model(ae, pc, device="cpu")
    model.adapter = torch.nn.Linear(2, 2)
    with pytest.raises(PrecisionError, match="adapter"):
        PrecisionPolicy("bf16").cast_model(model)
    assert model.encoder.conv0.conv.weight.dtype == torch.float32


def test_check_entropy_critical_trips_on_drift():
    ae, pc = _tiny()
    model = build_model(ae, pc, device="cpu")
    check_entropy_critical(model)
    model.probclass.conv1.weight.data = \
        model.probclass.conv1.weight.data.bfloat16()
    with pytest.raises(PrecisionError, match="frozen-point-exact"):
        check_entropy_critical(model)


def test_fake_quant_int8_matches_jax_on_edge_cases():
    rng = np.random.default_rng(3)
    for leaf in (rng.normal(size=(5, 7)).astype(np.float32),
                 np.zeros((4, 4), np.float32), np.array([1.0, -1.0],
                                                        np.float32),
                 np.zeros((0,), np.float32)):
        got = precision_lib._fake_quant_int8(leaf)
        want = np.asarray(jax_precision._fake_quant_int8(leaf), np.float32)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_compute_dtype_follows_rung():
    assert [PrecisionPolicy(r).compute_dtype for r in precision_lib.RUNGS] \
        == [jax_precision.PrecisionPolicy(r).compute_dtype
            for r in jax_precision.RUNGS]


# -- dtypes and values at the cast rungs --------------------------------------

def _jax_convbn_dtypes(module, variables, inp):
    _, state = module.apply(
        variables, inp, False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, jax_ae._ConvBN))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            state["intermediates"])[0]:
        keys = [p.key for p in path if hasattr(p, "key")][:-1]
        out[".".join(bridge._segment(k) for k in keys)] = str(leaf.dtype)
    return out


def _port_convbn_dtypes(module, inp):
    seen, hooks = {}, []
    for name, mod in module.named_modules():
        if isinstance(mod, ae_lib.ConvBN):
            hooks.append(mod.register_forward_hook(
                lambda m, a, o, name=name: seen.__setitem__(
                    name, str(o.dtype).replace("torch.", ""))))
    try:
        with torch.no_grad():
            module(inp)
    finally:
        for h in hooks:
            h.remove()
    return seen


@pytest.mark.parametrize("compute_dtype,rung", [("bfloat16", "bf16"),
                                                ("bfloat16", "fp32")])
def test_stage_dtypes_equal_jax(weights, compute_dtype, rung):
    """Every ConvBN, the bottleneck, z, the decoder and siNet outputs: at
    the bf16 rung every BN output is bfloat16 (its scale and bias are);
    with float32 parameters and a bfloat16 compute dtype they are float32."""
    params, stats, x = weights
    jmodel, jparams = _jax(params, compute_dtype, rung)
    port = _port(params, stats, compute_dtype, rung)
    for part, inp in (("encoder", x),
                      ("decoder", np.zeros((N, H // 8, W // 8, 8),
                                           np.float32))):
        jdt = _jax_convbn_dtypes(
            getattr(jmodel, part), {"params": jparams[part],
                                    "batch_stats": stats[part]}, inp)
        assert len(jdt) == 17
        assert _port_convbn_dtypes(getattr(port, part),
                                   torch.from_numpy(inp)) == jdt
        assert set(jdt.values()) == {"bfloat16" if rung != "fp32"
                                     else "float32"}
    jenc, _ = jmodel.encode(jparams, stats, x, train=False)
    jbott = jmodel.encoder.apply({"params": jparams["encoder"],
                                  "batch_stats": stats["encoder"]}, x, False)
    jdec, _ = jmodel.decode(jparams, stats, np.asarray(jenc.qbar),
                            train=False)
    jsi = jmodel.apply_sinet(jparams, np.asarray(jdec), x)
    with torch.no_grad():
        tx = torch.from_numpy(x)
        tbott = port.encoder(tx)
        tenc = port.encode(tx)
        tdec = port.decode(tenc.qbar)
        tsi = port.apply_sinet(tdec, tx)
    for name, j, t in (("bottleneck", jbott, tbott), ("z", jenc.z, tenc.z),
                       ("heatmap", jenc.heatmap, tenc.heatmap),
                       ("decoder", jdec, tdec), ("sinet", jsi, tsi)):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), name


def test_convbn_from_equal_bf16_inputs_agrees_within_ulps(rung_pair,
                                                          weights):
    _, _, jparams, port = rung_pair
    _, stats, _ = weights
    rng = np.random.default_rng(9)
    xb = jnp.asarray(rng.normal(size=(N, 10, 12, 128)).astype(np.float32),
                     jnp.bfloat16)
    sub = ("_ResGroupStack_0", "_ResBlock_0", "_ConvBN_0")
    jp, js = jparams["encoder"], stats["encoder"]
    for key in sub:
        jp, js = jp[key], js[key]
    jout = jax_ae._ConvBN(128, 3, dtype=jnp.bfloat16).apply(
        {"params": jp, "batch_stats": js}, xb, False)
    with torch.no_grad():
        tout = port.encoder.res.blocks[0].conv0(
            torch.from_numpy(np.asarray(xb, np.float32)).bfloat16()
            .permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tout.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    a = np.asarray(jout, np.float32)
    b = tout.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)
    ulps = np.abs(a - b) / ulp
    assert ulps.max() <= CONVBN_ULPS, ulps.max()
    assert (ulps > 0).mean() <= 1e-3, (ulps > 0).mean()


def test_nets_agree_with_jax_at_the_cast_rungs(rung_pair, weights):
    _, jmodel, jparams, port = rung_pair
    params, stats, x = weights
    jenc, _ = jmodel.encode(jparams, stats, x, train=False)
    jbott = np.asarray(jmodel.encoder.apply(
        {"params": jparams["encoder"], "batch_stats": stats["encoder"]}, x,
        False), np.float32)
    q = np.asarray(jenc.qbar)
    jdec, _ = jmodel.decode(jparams, stats, q, train=False)
    rng = np.random.default_rng(4)
    y_syn = rng.uniform(0, 255, x.shape).astype(np.float32)
    jsi = np.asarray(jmodel.apply_sinet(jparams, np.asarray(jdec), y_syn))
    with torch.no_grad():
        tx = torch.from_numpy(x)
        tbott = port.encoder(tx).float().numpy()
        tenc = port.encode(tx)
        tdec = port.decode(torch.from_numpy(q.copy())).numpy()
        tsi = port.apply_sinet(torch.from_numpy(np.array(jdec)),
                               torch.from_numpy(y_syn)).numpy()
    z = np.asarray(jenc.z)
    np.testing.assert_allclose(tbott, jbott, rtol=0,
                               atol=Z_REL * np.abs(jbott).max())
    np.testing.assert_allclose(tenc.z.numpy(), z, rtol=0,
                               atol=Z_REL * np.abs(z).max())
    np.testing.assert_allclose(tdec, np.asarray(jdec), rtol=0,
                               atol=DECODE_ATOL)
    np.testing.assert_allclose(tsi, jsi, rtol=0,
                               atol=SINET_REL * np.abs(jsi).max())
    # symbols: equal wherever z is clear of every decision boundary
    assert np.abs(tenc.z.numpy() - z).max() < SYMBOL_MARGIN
    centers = np.sort(params["centers"])
    mids = (centers[1:] + centers[:-1]) / 2
    clear = np.abs(z[..., None] - mids).min(axis=-1) > SYMBOL_MARGIN
    assert clear.mean() > 0.25, clear.mean()
    np.testing.assert_array_equal(tenc.symbols.numpy()[clear],
                                  np.asarray(jenc.symbols)[clear])


# -- the compute_dtype fault (ae_cityscapes_stereo) and the heatmap ramp ------

def test_compute_dtype_of_the_config_is_applied(weights):
    """A float32-parameter model whose config says compute_dtype =
    'bfloat16' (as ae_cityscapes_stereo does) runs its convs in bfloat16, as
    the JAX package does. The first ConvBN from equal float32 inputs agrees
    with the JAX package's bf16-compute ConvBN within float32 ordering slack
    (1e-5; one conv, rounded to bfloat16 in both, then a float32 BN), while
    float32 convs land 1e-3 or more away; and the port's z moves off its own
    float32 z."""
    params, stats, x = weights
    xn = np.asarray(jax_ae.normalize_image(x, "FIXED"))
    variables = {"params": params["encoder"]["_ConvBN_0"],
                 "batch_stats": stats["encoder"]["_ConvBN_0"]}
    j16, j32 = (np.asarray(jax_ae._ConvBN(64, 5, stride=2, dtype=dt).apply(
        variables, xn, False)) for dt in (jnp.bfloat16, jnp.float32))
    port16, port32 = _port(params, stats, "bfloat16"), _port(params, stats)
    with torch.no_grad():
        t16 = port16.encoder.conv0(torch.from_numpy(xn).permute(0, 3, 1, 2))
        z16 = port16.encode(torch.from_numpy(x)).z.numpy()
        z32 = port32.encode(torch.from_numpy(x)).z.numpy()
    t16 = t16.permute(0, 2, 3, 1).numpy()
    assert t16.dtype == j16.dtype == np.float32
    assert np.abs(j16 - j32).max() > 1e-3
    np.testing.assert_allclose(t16, j16, rtol=0, atol=1e-5)
    assert port16.encoder.conv0.dtype == torch.bfloat16
    assert port16.sinet.dtype == torch.bfloat16
    assert np.abs(z16 - z32).max() > 1e-3


def test_cityscapes_config_builds_bf16_convs():
    ae = parse_config_file(os.path.join(REPO, "dsin_tpu", "configs",
                                        "ae_cityscapes_stereo"))
    assert ae.compute_dtype == "bfloat16"
    encoder, decoder = ae_lib.Encoder(ae), ae_lib.Decoder(ae)
    convbns = [m for part in (encoder, decoder) for m in part.modules()
               if isinstance(m, ae_lib.ConvBN)]
    assert convbns and {m.dtype for m in convbns} == {torch.bfloat16}
    with pytest.raises(ValueError, match="compute_dtype"):
        ae_lib.compute_dtype(ae.replace(compute_dtype="float16"))


def test_heatmap_ramp_is_float32_for_a_bf16_bottleneck():
    rng = np.random.default_rng(5)
    b = jnp.asarray(rng.normal(0, 3, (2, 5, 6, 9)).astype(np.float32),
                    jnp.bfloat16)
    want = jax_ae.heatmap3d(b)
    got = ae_lib.heatmap3d(torch.from_numpy(np.asarray(b, np.float32))
                           .bfloat16())
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    # sigmoid(b0) * 8 is bfloat16 in both: one bfloat16 ulp of 8 apart
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2.0 ** -4)


# -- the loader and the streams -------------------------------------------------

@pytest.fixture(scope="module")
def config_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("precision_cfgs")
    ae, pc = _tiny()
    (d / "ae").write_text(str(ae))
    (d / "pc").write_text(str(pc))
    return str(d / "ae"), str(d / "pc")


@pytest.mark.parametrize("rung", precision_lib.RUNGS)
def test_load_model_state_casts_after_the_build(config_files, rung):
    fp32 = loader.load_model_state(*config_files, need_sinet=True,
                                   device="cpu")
    model = loader.load_model_state(*config_files, need_sinet=True,
                                    device="cpu", precision=rung)
    cdt = PrecisionPolicy(rung).compute_dtype
    assert model.ae_config.get("compute_dtype", "float32") == cdt
    assert model.encoder.conv0.dtype == ae_lib.compute_dtype(model.ae_config)
    ref = dict(fp32.named_parameters())
    for name, param in model.named_parameters():
        cast = PrecisionPolicy(rung).cast_leaf(ref[name].data)
        if name.split(".")[0] in precision_lib.ENTROPY_CRITICAL:
            cast = ref[name].data
        assert torch.equal(param.data, cast), name
    for name, buf in model.named_buffers():
        assert buf.dtype == dict(fp32.named_buffers())[name].dtype, name
    codec = loader.make_codec(model)
    for got, want in zip(codec.weights, loader.make_codec(fp32).weights):
        assert got[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_streams_are_byte_identical_across_rungs_and_packages(weights,
                                                              rung_pair):
    """Mode 2 byte-identical across the rungs and to the JAX package's
    stream of the same volume; mode 3 (K3's plain version on the CPU)
    byte-identical across the rungs; every stream round-trips."""
    params, stats, _ = weights
    rung, jmodel, jparams, port = rung_pair
    fp32 = _port(params, stats)
    vol = np.random.default_rng(11).integers(0, 6, (8, 5, 6)).astype(
        np.int32)
    jstream = jax_codec.BottleneckCodec.for_model(jmodel, jparams).encode(
        vol, mode="wavefront_np")
    codec, ref = loader.make_codec(port), loader.make_codec(fp32)
    assert codec.device.type == "cpu"
    for mode in ("wavefront_np", "wavefront_pl"):
        stream = codec.encode(vol, mode=mode)
        assert stream == ref.encode(vol, mode=mode), (rung, mode)
        np.testing.assert_array_equal(codec.decode(stream), vol)
        if mode == "wavefront_np":
            assert stream == jstream


def test_device_server_builds_on_the_rung():
    ae, pc = _tiny()
    server = DeviceServer(ae, pc, device="cpu", precision="int8")
    assert server.model.decoder.conv2.conv.weight.dtype == torch.bfloat16
    assert server.model.probclass.conv0.weight.dtype == torch.float32
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
    symbols, bpp = server.encode(x)
    prep = server.open_session(x[0])
    out = server.decode_si(symbols, prep)
    assert out.dtype == torch.float32 and tuple(out.shape) == (1, H, W, 3)
    assert bool(torch.isfinite(bpp).all())
    with pytest.raises(PrecisionError):
        DeviceServer(ae, pc, device="cpu", precision="fp8")


def test_bundled_kitti_config_is_fp32():
    assert ae_lib.compute_dtype(parse_config_file(
        config_path("ae_kitti_stereo"))) == torch.float32
