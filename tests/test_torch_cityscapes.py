"""The Cityscapes geometry in the port: 16x32 patches against the JAX
package, `tools/cityscapes_chip.py` on the CPU at a small crop (its OOM
retry included), and `main.run` training, validating and testing
`ae_cityscapes_stereo` with `spatial_shards = 1`, the standard prior never
materialized as an (Hc, Wc, P) tensor (`gaussian_position_mask` and the
element-for-element check are made to raise).

Bounds of the inference step as in tests/test_torch_eval_path.py: symbols
exact, images within 1e-3 of 255 and bpp within rtol 1e-5 (float32 nets
summing in another order), with every patch's top-two search margin above
1e-4 so no arg-max can flip under that noise.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsin_tpu.config import parse_config as jax_parse_config
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu.ops.sifinder import gaussian_position_mask
from dsin_tpu.train import step as jax_step
from dsin_tpu_torch import bridge
from dsin_tpu_torch import main as port_main
from dsin_tpu_torch.data import synthetic
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops import sifinder as sf
from dsin_tpu_torch.tools import cityscapes_chip
from dsin_tpu_torch.train import step as port_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PH, PW = 16, 32
CROP = (32, 64)          # the tool's and the run's CPU crop: 2 x 2 patches


@pytest.fixture
def no_materialized_prior(monkeypatch):
    """Any call that would build or check a whole (Hc, Wc, P) prior
    raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("the (Hc, Wc, P) prior was materialized")
    monkeypatch.setattr(sf, "gaussian_position_mask", refuse)
    monkeypatch.setattr(sf, "standard_mask_factors", refuse)


def test_inference_step_at_16x32_patches_matches_jax():
    """The tiny configuration with the Cityscapes patch (16x32) at a 64x128
    crop, through the tiled search in both packages."""
    h, w = 64, 128
    ae, pc = tiny_configs()
    ae = ae.replace(y_patch_size=(PH, PW), crop_size=(h, w),
                    sifinder_impl="tiled", sifinder_row_chunk=8)
    # seed 6: every top-two margin is 3.6e-3 or more (seed 4 has a 9e-6
    # near-tie, which the margin check below would refuse)
    model = build_model(ae, pc, device="cpu", seed=6)
    left, right = synthetic.make_stereo_pair(np.random.default_rng(6), h,
                                             w + 8)
    x = left[None, :, :w].astype(np.float32)
    y = right[None, :, 8:].astype(np.float32)
    with torch.no_grad():
        x_dec = model.decode(model.encode(torch.from_numpy(x)).qbar)[0]
        y_dec = model.decode(model.encode(torch.from_numpy(y)).qbar)[0]
    mask = gaussian_position_mask(h, w, PH, PW)
    score = sf.search_single(x_dec, torch.from_numpy(y[0]), y_dec, mask, PH,
                             PW).score_map
    top = torch.topk(score.reshape(-1, score.shape[-1]), 2, dim=0).values
    assert float((top[0] - top[1]).min()) > 1e-4
    sf.reset_route_counts()
    got = port_step.make_inference_step(
        model, si_mask=sf.standard_prior(h, w, PH, PW))(x, y)
    assert sf.route_counts["tiled"] == 1
    params, stats = bridge.jax_from_state_dict(model.state_dict())
    jae = jax_parse_config(str(ae.replace(sifinder_impl="xla_tiled")))
    jmodel = JaxDSIN(jae, jax_parse_config(str(pc)))
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


def test_the_tool_trains_on_the_cpu(no_materialized_prior, tmp_path):
    """`python -m dsin_tpu_torch.tools.cityscapes_chip --device cpu` at a
    small crop: one warm-up and one timed step through the tiled search,
    finite losses, every trained parameter moved, the report written."""
    out = tmp_path / "report.json"
    sf.reset_route_counts()
    assert cityscapes_chip.main(["--device", "cpu", "--crop", "32,64",
                                 "--steps", "1", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["ok"] and report["clock"] == "host"
    (attempt,) = report["attempts"]
    assert attempt["ok"] and attempt["sifinder_row_chunk"] == 32
    assert attempt["compute_dtype"] == "bfloat16" and attempt["remat"]
    assert all(math.isfinite(attempt[k])
               for k in ("first_loss", "last_loss", "bpp"))
    assert attempt["trained_params"] > 200 and attempt["unmoved_params"] == []
    assert len(attempt["step_ms"]) == 1 and attempt["search_ms"][0] > 0
    assert attempt["peak_bytes"] is None
    assert sf.route_counts == {"torch": 0, "tiled": 2, "kernel": 0}


def test_an_out_of_memory_retries_at_row_chunk_16(monkeypatch):
    """A torch.cuda.OutOfMemoryError at row chunk 32 is recorded and the
    run goes on at 16; any other error propagates."""
    real = sf.chunked_score_argmax

    def tight(xn, r_padded, inv_std_padded, hc, row_chunk, *args):
        if row_chunk == 32:
            raise torch.cuda.OutOfMemoryError("simulated: 32 rows")
        return real(xn, r_padded, inv_std_padded, hc, row_chunk, *args)

    monkeypatch.setattr(sf, "chunked_score_argmax", tight)
    report, trained = cityscapes_chip.run(steps=0, crop=CROP, device="cpu")
    first, second = report["attempts"]
    assert (first["sifinder_row_chunk"], first["ok"]) == (32, False)
    assert "simulated: 32 rows" in first["error"]
    assert (second["sifinder_row_chunk"], second["ok"]) == (16, True)
    assert report["ok"] and trained.config.sifinder_row_chunk == 16

    def broken(*args):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(sf, "chunked_score_argmax", broken)
    with pytest.raises(RuntimeError, match="not a memory error"):
        cityscapes_chip.run(steps=0, crop=CROP, device="cpu")


def test_main_runs_the_cityscapes_config(no_materialized_prior, tmp_path):
    """`main.run` with ae_cityscapes_stereo at spatial_shards = 1 (cut to a
    32x64 crop): a train step, a validation, a test image, the priors as
    factors; spatial_shards = 4 raises naming ROADMAP item 6."""
    root = str(tmp_path)
    manifests = synthetic.write_corpus(root, 2, 1, 1, 40, 72, seed=5)
    for split, path in manifests.items():
        os.rename(path, os.path.join(root, f"{split}.txt"))
    ae, pc = cityscapes_chip.configs(CROP, 32)
    ae = ae.replace(root_data=root, file_path_train="train.txt",
                    file_path_val="val.txt", file_path_test="test.txt",
                    sifinder_impl="auto", test_model=True, save_model=False,
                    validate_every=1, show_every=1)
    with pytest.raises(NotImplementedError, match="item 6"):
        port_main.Experiment(ae.replace(spatial_shards=4), pc, device="cpu")
    seen = []
    results = port_main.run(ae, pc, out_root=root, max_steps=1,
                            device="cpu",
                            on_image=lambda exp, i, rec: seen.append(exp))
    assert results["steps"] == 1 and math.isfinite(results["best_val"])
    exp = seen[0]
    assert len(seen) == 1 and math.isfinite(results["psnr"])
    for prior in (exp.train_mask, exp.eval_mask):
        assert prior.mask is None and prior.shape() == (17, 33, 4)
