"""The port's precision RD-delta gate (`dsin_tpu_torch/tools/rd_delta.py`)
against the JAX package's (`bench.py` `run_rd_delta`) on the CPU, at the
tiny configuration (40x48 images, 8 bottleneck channels).

The JAX package's seed-0 weights (`DSIN.init_variables` under
`PRNGKey(0)`, the init the JAX gate's loader draws) are carried into the
port by `bridge.py`; each rung's reconstruction goes through the JAX
package's batched serve functions and the port's `DeviceServer` on the
same images. Bounds:
  * fp32: PSNR within 1e-3 dB and MS-SSIM within 1e-5 of the JAX
    pipeline's (the gate rounds them to 4 and 6 decimals; the two nets sum
    their convolutions in another order, which moves the last bits);
  * bf16 and int8: within 0.05 dB and 5e-3, half the tighter (bf16)
    MS-SSIM budget, so the two gates agree on a verdict unless a delta
    lies within that of its budget. The two packages' bfloat16 nets round
    their 17 convolutions in another order (tests/test_torch_precision.py
    bounds the decoder within 2 of [0, 255]); measured here: 1e-3 / 3e-3
    dB and 2.6e-3 / 2.7e-3 (bf16 / int8), the same size as the rungs' own
    deltas against fp32;
  * the mode-2 stream's sha256, at every rung, equals the JAX codec's on
    the same volume (exact: the entropy side is float32 at every rung and
    mode 2 is byte-identical across the packages).
A probclass weight perturbed at one rung fails the hard gate (exit 1), as
does a budget the deltas exceed.
"""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsin_tpu.coding import loader as jax_loader
from dsin_tpu.coding import precision as jax_precision
from dsin_tpu.config import parse_config_file as jax_parse_config_file
from dsin_tpu.eval.msssim_np import multiscale_ssim_np as jax_msssim
from dsin_tpu.eval.reporting import psnr_np as jax_psnr
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu.serve.service import _make_batched_fns
from dsin_tpu.train.step import TrainState
from dsin_tpu_torch.coding import precision as precision_lib
from dsin_tpu_torch.coding.loader import build_at_rung
from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.serve.device import DeviceServer
from dsin_tpu_torch.tools import rd_delta
from dsin_tpu_torch.train import checkpoint as port_ckpt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W = 40, 48
TOL = {"fp32": (1e-3, 1e-5), "bf16": (0.05, 5e-3), "int8": (0.05, 5e-3)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("rd_delta")
    ae, pc = tiny_configs()
    (d / "ae").write_text(str(ae.replace(AE_only=True)))
    (d / "pc").write_text(str(pc))
    paths = (str(d / "ae"), str(d / "pc"))
    jmodel = JaxDSIN(jax_parse_config_file(paths[0]),
                     jax_parse_config_file(paths[1]))
    variables = jax.jit(jmodel.init_variables, static_argnums=1)(
        jax.random.PRNGKey(0), (1, H, W, 3))
    params = jax.tree_util.tree_map(np.asarray, variables.params)
    stats = jax.tree_util.tree_map(np.asarray, variables.batch_stats)
    port = rd_delta.run_rd_delta(*paths, H, W, device="cpu",
                                 params=(params, stats))
    return paths, params, stats, port


def _jax_rung(paths, params, stats, rung, x):
    """The JAX gate's per-rung pipeline on the given weights."""
    policy = jax_precision.PrecisionPolicy(rung)
    cfg = jax_parse_config_file(paths[0]).replace(AE_only=True)
    if rung != "fp32":
        cfg = cfg.replace(compute_dtype=policy.compute_dtype)
    model = JaxDSIN(cfg, jax_parse_config_file(paths[1]))
    cast = policy.cast_params(params)
    encode_fn, decode_fn = _make_batched_fns(model)
    sym = encode_fn(cast, stats, jnp.asarray(x))
    x_dec = np.asarray(decode_fn(cast, stats, sym))
    state = TrainState(params=cast, batch_stats=stats, opt_state=(),
                       step=jnp.int32(0))
    return x_dec, jax_loader.make_codec(model, state)


def test_the_gate_passes_with_identical_streams(setup):
    _, _, _, port = setup
    assert port["pass"] is True and port["violations"] == []
    assert port["streams_bit_identical"] is True
    assert port["shape"] == [H, W] and port["unit"] == "dB"
    assert set(port["per_rung"]) == set(precision_lib.RUNGS)
    for rung in ("bf16", "int8"):
        entry = port["per_rung"][rung]
        assert entry["budgets"] == dict(zip(("psnr_db", "msssim"),
                                            rd_delta.BUDGETS[rung]))
        assert entry["psnr_delta"] == round(
            port["per_rung"]["fp32"]["psnr"] - entry["psnr"], 4)
    assert port["value"] == max(port["per_rung"][r]["psnr_delta"]
                                for r in ("bf16", "int8"))


def test_the_images_are_the_jax_gates(setup):
    """The same structured images as bench.py builds them."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    grad = (yy / H * 160.0 + xx / W * 80.0)[..., None] * np.ones(3)
    want = np.clip(grad[None] + rng.normal(0.0, 24.0, size=(2, H, W, 3)),
                   0, 255).astype(np.float32)
    np.testing.assert_array_equal(rd_delta.gate_images(H, W), want)


@pytest.mark.parametrize("rung", precision_lib.RUNGS)
def test_each_rung_scores_as_the_jax_pipeline(setup, rung):
    paths, params, stats, port = setup
    x = rd_delta.gate_images(H, W)
    x_dec, jcodec = _jax_rung(paths, params, stats, rung, x)
    psnr_tol, ms_tol = TOL[rung]
    entry = port["per_rung"][rung]
    assert abs(entry["psnr"] - jax_psnr(x, x_dec)) <= psnr_tol
    assert abs(entry["msssim"] - jax_msssim(x, x_dec, levels=3)) <= ms_tol
    # the mode-2 stream of the gate's volume: the port's fp32 symbols of
    # the first image, coded by the JAX codec of this rung
    model, _ = build_at_rung(
        parse_config_file(paths[0]), parse_config_file(paths[1]),
        device="cpu", state=port_ckpt.ModelState(params, stats))
    sym = DeviceServer.for_model(model).encode_symbols(x).numpy()
    volume = np.ascontiguousarray(np.transpose(sym[0], (2, 0, 1)))
    stream = jcodec.encode(volume.astype(np.int32), mode="wavefront_np")
    assert hashlib.sha256(stream).hexdigest() == \
        entry["stream_sha256"]["wavefront_np"]


def test_a_perturbed_probclass_at_one_rung_fails_the_hard_gate(
        setup, monkeypatch, capsys):
    paths, _, _, _ = setup
    real = rd_delta.build_at_rung

    def perturbed(*args, precision="fp32", **kwargs):
        model, record = real(*args, precision=precision, **kwargs)
        if precision == "int8":
            weight = model.probclass.conv1.weight
            weight.data[(0,) * weight.dim()] += 0.5
        return model, record

    monkeypatch.setattr(rd_delta, "build_at_rung", perturbed)
    rc = rd_delta.main(["--ae_config", paths[0], "--pc_config", paths[1],
                        "--h", str(H), "--w", str(W), "--device", "cpu"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and result["pass"] is False
    assert result["streams_bit_identical"] is False
    assert any(v.startswith("HARD") for v in result["violations"])


def test_a_budget_violation_exits_1(setup, capsys):
    paths, _, _, _ = setup
    rc = rd_delta.main(["--ae_config", paths[0], "--pc_config", paths[1],
                        "--h", str(H), "--w", str(W), "--device", "cpu",
                        "--psnr_budget_bf16", "-100"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and result["streams_bit_identical"] is True
    assert [v for v in result["violations"]
            if v.startswith("bf16 PSNR delta")]
