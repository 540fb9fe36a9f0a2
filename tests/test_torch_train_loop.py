"""The port's train / validate / test loop (`dsin_tpu_torch/main.py`) on the
CPU at a tiny configuration (32x48 crops, 8x12 patches, B = 1) and a
synthetic split (`data/synthetic.py`), modelled on the JAX package's
tests/test_main.py: the validation schedule, best-val, periodic and
emergency checkpoints, resume numbering and best_val seeding, the
divergence guard, the rate-target stop, `run` train -> best -> test, the
CLI, and the port's loop against the JAX package's `Experiment.train` on
one split from the same weights.

Bound of that comparison: the same iterations validate, and the val losses
agree within rtol 1e-4 (the two trajectories part by float32 rounding,
amplified by Adam's sign-like first step on a sliver of the elements:
tests/test_torch_train_checkpoint.py measures 4e-7 over five steps).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsin_tpu.config import parse_config as jax_parse_config
from dsin_tpu.main import Experiment as JaxExperiment
from dsin_tpu.main import get_validate_every as jax_get_validate_every
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu.ops.sifinder import gaussian_position_mask
from dsin_tpu.train import optim as jax_optim
from dsin_tpu.train import step as jax_step
from dsin_tpu_torch import bridge
from dsin_tpu_torch import main as port_main
from dsin_tpu_torch.config import parse_config
from dsin_tpu_torch.data import synthetic
from dsin_tpu_torch.data.manifest import read_pair_manifest
from dsin_tpu_torch.train import checkpoint as port_ckpt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _configs(root, **over):
    ae = parse_config(f"""
        iterations = 4
        crop_size = (32, 48)
        eval_crop_size = (32, 48)
        batch_size = 1
        num_crops_per_img = 1
        do_flips = True
        show_every = 2
        validate_every = 2
        decrease_val_steps = False
        arch = CVPR
        arch_param_B = 1
        num_chan_bn = 8
        heatmap = True
        num_centers = 6
        centers_initial_range = (-2, 2)
        AE_only = False
        si_weight = 0.7
        y_patch_size = (8, 12)
        use_gauss_mask = True
        use_L2andLAB = False
        H_target = 0.08
        beta = 500
        distortion_to_minimize = 'mae'
        K_psnr = 100
        K_ms_ssim = 5000
        regularization_factor = 0.0005
        regularization_factor_centers = 0.01
        normalization = 'FIXED'
        bn_stats = 'update'
        optimizer = 'ADAM'
        optimizer_momentum = 0.9
        lr_initial = 1e-4
        lr_schedule = 'FIXED'
        lr_centers_factor = None
        train_autoencoder = True
        train_probclass = True
        load_model = False
        load_train_step = False
        train_model = True
        test_model = True
        save_model = True
        load_model_name = ''
        root_data = '{root}'
        file_path_train = 'train.txt'
        file_path_val = 'val.txt'
        file_path_test = 'test.txt'
        """)
    pc = parse_config("""
        arch = res_shallow
        kernel_size = 3
        arch_param__k = 8
        use_centers_for_padding = True
        regularization_factor = None
        optimizer = 'ADAM'
        optimizer_momentum = 0.9
        lr_initial = 1e-4
        lr_schedule = 'FIXED'
        """)
    return ae.replace(**over), pc


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three train, two val and two test pairs at 40x56 with their
    manifests."""
    root = tmp_path_factory.mktemp("loop_data")
    manifests = synthetic.write_corpus(str(root), 3, 2, 2, 40, 56, seed=2)
    for split, path in manifests.items():
        os.rename(path, os.path.join(str(root), f"{split}.txt"))
    return str(root)


def _val_records(out, name):
    with open(os.path.join(out, "logs", f"{name}.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["val_loss"]) for r in recs if "val_loss" in r]


def test_get_validate_every_schedule():
    assert port_main.get_validate_every(0, 1000, 100, True) == 100
    assert port_main.get_validate_every(499, 1000, 100, True) == 100
    assert port_main.get_validate_every(500, 1000, 100, True) == 50
    assert port_main.get_validate_every(750, 1000, 100, True) == 25
    assert port_main.get_validate_every(900, 1000, 100, False) == 100
    for i in range(0, 40, 3):
        for decrease in (True, False):
            assert port_main.get_validate_every(i, 40, 7, decrease) == \
                jax_get_validate_every(i, 40, 7, decrease)


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """`run` with train_model and test_model: 4 steps, validations at 2
    and 4, two test images."""
    out = str(tmp_path_factory.mktemp("loop_out"))
    ae, pc = _configs(data)
    results = port_main.run(ae, pc, out_root=out, max_steps=4,
                            max_val_batches=2, max_test_images=2,
                            device="cpu")
    (name,) = [d for d in os.listdir(os.path.join(out, "weights"))
               if os.path.isdir(os.path.join(out, "weights", d))
               and ".prev-" not in d]
    return out, name, results, ae, pc


def test_run_trains_validates_saves_and_tests(trained):
    out, name, results, _, _ = trained
    assert results["steps"] == 4
    assert np.isfinite(results["best_val"])
    assert "bpp" in results and "psnr" in results
    ckpt = os.path.join(out, "weights", name)
    for f in ("params_encoder.msgpack", "params_sinet.msgpack",
              "opt_state.msgpack", "batch_stats.msgpack", "meta.json",
              "manifest.json"):
        assert os.path.exists(os.path.join(ckpt, f)), f
    meta = port_ckpt.load_meta(ckpt)
    assert meta["best_val"] == results["best_val"]
    assert "opt_state.msgpack" in port_ckpt.load_manifest(ckpt)["files"]
    weights = os.path.join(out, "weights")
    assert os.path.exists(os.path.join(weights, f"last_saved_{name}.txt"))
    assert os.path.exists(os.path.join(weights, f"configs_{name}.txt"))
    # the validation schedule: every 2 steps, and the last
    assert [s for s, _ in _val_records(out, name)] == [2, 4]
    pngs = [f for f in os.listdir(os.path.join(out, "images", name))
            if f.endswith("bpp.png")]
    assert len(pngs) == 2


def test_resume_continues_numbering_and_seeds_best_val(trained):
    out, name, results, ae, pc = trained
    # the run reached its config's 4 iterations; a longer schedule resumes
    ae2 = ae.replace(load_model=True, load_train_step=True,
                     load_model_name=name, test_model=False, iterations=8)
    exp = port_main.Experiment(ae2, pc, out_root=out, device="cpu")
    exp.maybe_restore()
    meta = port_ckpt.load_meta(os.path.join(out, "weights", name))
    assert exp.step == meta["step"] >= 4
    assert exp.restored_best_val == pytest.approx(results["best_val"])
    counts = [g.count for g in exp.optimizer.groups.values()
              if g.kind != "frozen"]
    assert set(counts) == {meta["step"]}
    r = exp.train(max_steps=2, max_val_batches=1)
    assert r["steps"] == 2 and exp.step == meta["step"] + 2
    # a phase switch (weights only) does not inherit best_val or the step
    ae3 = ae2.replace(load_train_step=False)
    exp3 = port_main.Experiment(ae3, pc, out_root=out, device="cpu")
    exp3.maybe_restore()
    assert exp3.restored_best_val == float("inf") and exp3.step == 0


def test_periodic_and_emergency_checkpoints(data, tmp_path):
    out = str(tmp_path)
    ae, pc = _configs(data, checkpoint_every=2, validate_every=100)
    exp = port_main.Experiment(ae, pc, out_root=out, device="cpu")
    exp.train(max_steps=2, max_val_batches=1)
    periodic = os.path.join(exp.ckpt_dir, "periodic")
    assert port_ckpt.load_meta(periodic)["kind"] == "periodic"
    assert os.path.exists(os.path.join(periodic, "opt_state.msgpack"))

    for error in (RuntimeError("boom"), KeyboardInterrupt()):
        exp2 = port_main.Experiment(ae, pc, out_root=out, device="cpu")
        real_step = exp2.train_step
        calls = {"n": 0}

        def failing_step(x, y, real_step=real_step, calls=calls,
                         error=error):
            calls["n"] += 1
            if calls["n"] > 1:
                raise error
            return real_step(x, y)

        exp2.train_step = failing_step
        with pytest.raises(type(error)):
            exp2.train(max_steps=4, max_val_batches=1)
        meta = port_ckpt.load_meta(os.path.join(exp2.ckpt_dir, "emergency"))
        assert meta["kind"] == "emergency" and meta["step"] == 1
        assert type(error).__name__ in meta["error"]


def test_divergence_guard_stops_sustained_blowup(data, tmp_path):
    ae, pc = _configs(data, iterations=40, validate_every=1,
                      test_model=False, divergence_factor=2.0,
                      divergence_patience=3, save_model=False)

    def scripted(vals):
        seq = iter(vals)
        return lambda batches, max_batches=None: float(next(seq, vals[-1]))

    exp = port_main.Experiment(ae, pc, out_root=str(tmp_path), device="cpu")
    exp.validate = scripted([10.0, 30.0, 30.0, 30.0, 30.0, 30.0])
    r = exp.train(max_val_batches=1)
    assert r["diverged_stop"] is True and r["steps"] <= 6
    assert r["best_val"] == 10.0

    exp2 = port_main.Experiment(ae, pc, out_root=str(tmp_path / "b"),
                                device="cpu")
    exp2.validate = scripted([10.0, 30.0, 30.0, 11.0] * 10)
    r2 = exp2.train(max_steps=8, max_val_batches=1)
    assert r2["diverged_stop"] is False and r2["steps"] == 8


def test_until_rate_target_stops_early_and_checkpoints(data, tmp_path):
    ae, pc = _configs(data, iterations=30, H_target=50.0,
                      validate_every=1000, test_model=False)
    exp = port_main.Experiment(ae, pc, out_root=str(tmp_path), device="cpu")
    r = exp.train(until_rate_target=True, rate_window=2, max_val_batches=1)
    assert r["steps"] == 2 and np.isfinite(r["best_val"])
    assert os.path.exists(os.path.join(exp.ckpt_dir, "opt_state.msgpack"))


def test_the_cli_trains_resumes_and_tests_on_the_cpu(data, tmp_path, capsys):
    out = str(tmp_path)
    ae, pc = _configs(data)
    ae_path, pc_path = tmp_path / "ae", tmp_path / "pc"
    ae_path.write_text(str(ae))
    pc_path.write_text(str(pc))
    args = ["-ae_config", str(ae_path), "-pc_config", str(pc_path),
            "--out_root", out, "--max_steps", "2", "--max_val_batches", "1",
            "--max_test_images", "1"]
    if not torch.cuda.is_available():
        # without --device the run asks for the card, and there is none
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_main.main(args)
    args += ["--device", "cpu"]
    port_main.main(args)
    assert "done:" in capsys.readouterr().out
    (name,) = [d for d in os.listdir(os.path.join(out, "weights"))
               if os.path.isdir(os.path.join(out, "weights", d))
               and ".prev-" not in d]
    resume = ae.replace(load_model=True, load_train_step=True,
                        load_model_name=name)
    ae_path.write_text(str(resume))
    port_main.main(args)
    text = capsys.readouterr().out
    assert "restored from" in text and "(step 2," in text
    assert "[4/4]" in text


def _jax_trainer(ae, pc, out, params, batch_stats):
    """The JAX package's Experiment on one device, set up as its __init__
    sets it up but from the given weights: the __init__ draws its own by
    tracing the model's init eagerly (30 s on the CPU)."""
    jae, jpc = jax_parse_config(str(ae)), jax_parse_config(str(pc))
    exp = JaxExperiment.__new__(JaxExperiment)
    exp.ae_config, exp.pc_config, exp.out_root = jae, jpc, out
    exp.seed, exp.replicate_to, exp.mesh = 0, None, None
    exp.model = JaxDSIN(jae, jpc)
    exp.num_train_imgs = len(read_pair_manifest(
        os.path.join(jae.root_data, jae.file_path_train), jae.root_data))
    exp.tx = jax_optim.build_optimizer(None, jae, jpc, exp.num_train_imgs)
    exp.state = jax_step.TrainState(params=params, batch_stats=batch_stats,
                                    opt_state=exp.tx.init(params),
                                    step=jnp.int32(0))
    (ch, cw), (ph, pw) = jae.crop_size, jae.y_patch_size
    exp.train_mask = jnp.asarray(gaussian_position_mask(ch, cw, ph, pw))
    exp.train_step = jax_step.make_train_step(exp.model, exp.tx,
                                              si_mask=exp.train_mask)
    exp.val_step = jax_step.make_eval_step(exp.model, si_mask=exp.train_mask)
    exp._put = lambda x, y: (jnp.asarray(x), jnp.asarray(y))
    exp.model_name = "jax"
    exp.weights_root = os.path.join(out, "weights")
    exp.ckpt_dir = os.path.join(exp.weights_root, exp.model_name)
    return exp


def test_the_loop_matches_the_jax_experiment(data, tmp_path):
    """The same split, the same weights (the port's seeded ones, carried by
    the bridge) and the same crops (both loaders seed 0): validations at
    the same iterations, val losses within rtol 1e-4."""
    ae, pc = _configs(data, test_model=False, iterations=4,
                      validate_every=2)
    pexp = port_main.Experiment(ae, pc, out_root=str(tmp_path / "port"),
                                device="cpu")
    jexp = _jax_trainer(ae, pc, str(tmp_path / "jax"),
                        *bridge.jax_from_state_dict(
                            pexp.model.state_dict()))
    jr = jexp.train(max_val_batches=2)
    pr = pexp.train(max_val_batches=2)
    jv = _val_records(str(tmp_path / "jax"), jexp.model_name)
    pv = _val_records(str(tmp_path / "port"), pexp.model_name)
    assert [s for s, _ in pv] == [s for s, _ in jv] == [2, 4]
    np.testing.assert_allclose([v for _, v in pv], [v for _, v in jv],
                               rtol=1e-4)
    assert pr["steps"] == jr["steps"] == 4
    assert int(jexp.state.step) == pexp.step == 4
    assert jnp.isfinite(jr["best_val"])
