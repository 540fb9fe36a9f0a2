"""The port's rate-distortion runners and its step profiler on the CPU,
held against the JAX package (`dsin_tpu/eval/{rd_sweep,synthetic_rd}.py`,
`dsin_tpu/utils/profiling.py`).

Exact throughout: the bpp <-> H_target map and the default targets; resume
discovery (`_latest_resumable`, `_prior_best_dir`) on one directory tree of
matching and foreign attempts, periodic, emergency, torn and `.prev-*`
dirs; the CLI's configuration (overrides, rewiring, the generated
corpus's manifests); the sweep's `rd_curve.json` from the same point
results; the profiler's window, step by step. Then the port's runners at
the tiny configuration (32x48 crops): `run_3phase`'s resume-instead-of-
restart contract (tests/test_synthetic.py's, which the JAX package runs
only as a slow test), its warm start, and the sweep's point-by-point
file; and `train(profile_dir=)`'s trace window, drain and `finally`.

Not held here: `run_3phase`'s val losses against the JAX package's. The
JAX `Experiment` traces its model's init eagerly (about 30 s on the CPU
for each of its two phases), beyond this file's budget; the loop itself is
held against the JAX loop in tests/test_torch_train_loop.py.
"""

import json
import os

import numpy as np
import pytest
import torch

import dsin_tpu.eval.synthetic_rd as jax_rd
from dsin_tpu.config import parse_config_file as jax_parse_config_file
from dsin_tpu.eval import rd_sweep as jax_sweep
from dsin_tpu.utils import profiling as jax_profiling
from dsin_tpu_torch import main as port_main
from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.data import synthetic
from dsin_tpu_torch.eval import rd_sweep, synthetic_rd
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.runtime import config_path
from dsin_tpu_torch.train import checkpoint as port_ckpt
from dsin_tpu_torch.utils import profiling
from test_torch_train_loop import _configs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(REPO, "dsin_tpu", "configs")


# -- the pure parts, against the JAX package ---------------------------------

@pytest.mark.parametrize("bpp,c", [(0.01, 32), (0.02, 32), (0.08, 16),
                                   (0.04, 8), (0.123, 7)])
def test_h_target_for_bpp_and_the_default_targets(bpp, c):
    assert rd_sweep.DEFAULT_TARGETS == jax_sweep.DEFAULT_TARGETS
    assert rd_sweep.h_target_for_bpp(bpp, c) == \
        jax_sweep.h_target_for_bpp(bpp, c)


def _tree(out, ae):
    """One weights tree of every case resume discovery meets."""
    weights = os.path.join(out, "weights")

    def name(ae_only, target, stamp):
        return port_ckpt.model_name_for(
            ae.replace(AE_only=ae_only,
                       H_target=target * 64.0 / ae.num_chan_bn), stamp)

    def mk(d, step=None, torn=False):
        d = os.path.join(weights, d)
        os.makedirs(d, exist_ok=True)
        if not torn:
            with open(os.path.join(d, "meta.json"), "w") as f:
                json.dump({"step": step}, f)

    target = ae.H_target / (64.0 / ae.num_chan_bn)
    a = name(True, target, "20260101_000000")
    b = name(True, target, "20260102_000000")
    c = name(False, target, "20260103_000000")
    d = name(False, target, "20260104_000000")
    mk(a, 100)
    mk(f"{a}/periodic", 400)
    mk(f"{a}/emergency", 350)
    mk(b, 300)
    mk(f"{b}/emergency", 900, torn=True)          # torn: no meta
    mk(name(True, target * 2, "20260105_000000"), 5000)   # other target
    mk(c, 50)
    mk(f"{c}/periodic.prev-000001", 700)           # a kill in the swap
    mk(f"{d}.prev-000002", 650)                    # the live dir gone
    with open(os.path.join(weights, c, "periodic.tmp-1"), "w"):
        pass
    # a corrupt meta is skipped, not fatal
    os.makedirs(os.path.join(weights, d, "emergency"))
    with open(os.path.join(weights, d, "emergency", "meta.json"), "w") as f:
        f.write("{not json")


@pytest.mark.parametrize("ae_only", [True, False])
def test_resume_discovery_equals_the_jax_package(tmp_path, ae_only):
    ae = parse_config_file(config_path("ae_synthetic_micro"))
    jae = jax_parse_config_file(os.path.join(JAX_CONFIGS,
                                             "ae_synthetic_micro"))
    out = str(tmp_path)
    assert synthetic_rd._latest_resumable(out, ae, ae_only) == \
        jax_rd._latest_resumable(out, jae, ae_only) == (None, 0)
    _tree(out, ae)
    got = synthetic_rd._latest_resumable(out, ae, ae_only)
    assert got == jax_rd._latest_resumable(out, jae, ae_only)
    assert got[1] == (400 if ae_only else 700)
    assert synthetic_rd._prior_best_dir(out, got[0]) == \
        jax_rd._prior_best_dir(out, got[0])
    for prior in (None, "", "x/periodic", "x/emergency", "x"):
        assert synthetic_rd._prior_best_dir(out, prior) == \
            jax_rd._prior_best_dir(out, prior)


def _jax_cli(argv, monkeypatch):
    """The config the JAX CLI runs for `argv`, caught at its run_3phase."""
    seen = {}
    monkeypatch.setattr(jax_rd, "run_3phase",
                        lambda ae, pc, out, **kw: seen.update(ae=ae))
    jax_rd.main(argv)
    return seen["ae"]


def _port_cli(argv):
    """The config the port's CLI runs for `argv`, and the seconds it spent
    generating a corpus."""
    ae, _, corpus_s = synthetic_rd.configs_from_args(
        synthetic_rd.parse_args(argv))
    return ae, corpus_s


def test_the_cli_configuration_equals_the_jax_package(tmp_path,
                                                      monkeypatch):
    pytest.importorskip("PIL")    # the JAX package writes its PNGs with PIL
    ae, pc = _configs("/nonexistent", eval_crop_size=(16, 24),
                      file_path_train="KITTI_stereo_train.txt")
    (tmp_path / "ae").write_text(str(ae))
    base = ["-ae_config", str(tmp_path / "ae"), "--out_root",
            str(tmp_path / "out")]
    over = ["--target_bpp", "0.04", "--iterations", "7"]
    # a corpus is generated where none is, and the config rewired to it
    jdata, pdata = str(tmp_path / "jdata"), str(tmp_path / "pdata")
    jae = _jax_cli(base + ["--data_dir", jdata] + over, monkeypatch)
    pae, corpus_s = _port_cli(base + ["--data_dir", pdata] + over)
    assert corpus_s > 0
    assert str(pae).replace(pdata, jdata) == str(jae)
    assert pae.H_target == 0.04 * 64.0 / ae.num_chan_bn
    assert pae.iterations == 7
    for split, count in zip(("train", "val", "test"),
                            synthetic_rd.CORPUS_PAIRS):
        for root, cfg in ((pdata, pae), (jdata, jae)):
            with open(os.path.join(root, getattr(cfg, f"file_path_{split}"))
                      ) as f:
                assert len(f.read().split()) == 2 * count
    # an existing synthetic corpus is rewired to, not regenerated
    argv = base + ["--data_dir", pdata, "--H_target", "0.5"]
    pae, corpus_s = _port_cli(argv)
    assert corpus_s == 0
    assert str(pae) == str(_jax_cli(argv, monkeypatch))
    assert pae.H_target == 0.5
    assert pae.file_path_train == "synthetic_stereo_train.txt"
    bad = base + ["--H_target", "1", "--target_bpp", "0.1"]
    with pytest.raises(SystemExit):
        jax_rd.main(bad)
    with pytest.raises(SystemExit):
        synthetic_rd.parse_args(bad)


def test_the_sweep_writes_the_jax_packages_curve(tmp_path, monkeypatch):
    """The same point results give the same `rd_curve.json`, written
    after every point."""
    import dsin_tpu.main as jax_main

    def fake(files):
        def run(cfg, pc, out_root, **kw):
            path = os.path.join(out_root, "rd_curve.json")
            files.append(json.load(open(path)) if os.path.exists(path)
                         else None)
            return {"bpp": cfg.H_target / 4, "psnr": 30.0 + cfg.H_target}
        return run

    ae, pc = _configs(str(tmp_path))
    jfiles, pfiles = [], []
    monkeypatch.setattr(jax_main, "run", fake(jfiles))
    monkeypatch.setattr(port_main, "run", fake(pfiles))
    jpoints = jax_sweep.sweep(ae, pc, out_root=str(tmp_path / "j"),
                              targets=(0.02, 0.08))
    ppoints = rd_sweep.sweep(ae, pc, out_root=str(tmp_path / "p"),
                             targets=(0.02, 0.08), device="cpu")
    assert ppoints == jpoints
    assert [len(f) if f else 0 for f in pfiles] == [0, 1]
    assert pfiles == jfiles
    with open(tmp_path / "p" / "rd_curve.json") as f:
        assert json.load(f) == ppoints
    assert [p["H_target"] for p in ppoints] == \
        [b * 64.0 / ae.num_chan_bn for b in (0.02, 0.08)]


def test_the_profiler_window_equals_the_jax_package(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_profiling.jax.profiler, "start_trace",
                        lambda d: None)
    monkeypatch.setattr(jax_profiling.jax.profiler, "stop_trace",
                        lambda: None)
    for start, steps in ((5, 3), (0, 3), (2, 1)):
        jprof = jax_profiling.StepProfiler(str(tmp_path / "j"), start, steps)
        pprof = profiling.StepProfiler(str(tmp_path / "p"), start, steps)
        jflags, pflags = [], []
        for i in range(10):
            jprof.step(i)
            pprof.step(i)
            jflags.append(jprof.active)
            pflags.append(pprof.active)
        assert pflags == jflags
        assert pflags.count(True) == steps
        assert pprof.trace_path is not None
    off = profiling.StepProfiler(None)
    off.step(5)
    assert not off.active
    with off.annotation(5):
        pass


# -- the port's runners at the tiny configuration ----------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Three train, two val and one test pair at 40x56, as the synthetic
    corpus names them."""
    root = str(tmp_path_factory.mktemp("rd_data"))
    synthetic.write_corpus(root, 3, 2, 1, 40, 56, seed=3)
    ae, pc = _configs(root, test_model=False, validate_every=2,
                      **{f"file_path_{s}": f"synthetic_stereo_{s}.txt"
                         for s in ("train", "val", "test")})
    return ae, pc


def test_run_3phase_resumes_instead_of_restarting(split, tmp_path):
    """tests/test_synthetic.py's contract on the port: a retry skips a
    finished phase 1 by its marker and resumes an interrupted phase from
    the furthest checkpoint, the done steps deducted from the phase's
    budget (at least 1 step). A fresh phase 2 restores the AE partitions
    of phase 1's scored checkpoint and leaves siNet at its seeded init."""
    ae, pc = split
    ae = ae.replace(iterations=100)
    out = str(tmp_path / "run")
    prior = port_main.Experiment(
        ae.replace(AE_only=True, train_model=True, test_model=False), pc,
        out_root=out, device="cpu")
    prior.train(max_steps=2, max_val_batches=1)
    name, step = synthetic_rd._latest_resumable(out, ae, ae_only=True)
    assert name is not None and step == 2

    restored = {}

    def on_restore(phase, exp):
        restored[phase] = {k: v.clone()
                           for k, v in exp.model.state_dict().items()}

    r = synthetic_rd.run_3phase(ae, pc, out, phase1_steps=3,
                                phase2_steps=2, max_test_images=1,
                                device="cpu", on_restore=on_restore)
    assert r["phase1"]["steps"] == 1                # 3 - 2 already done
    assert r["phase2"]["steps"] == 2
    assert os.path.exists(os.path.join(out, "phase1_done.json"))
    for key in ("bpp", "psnr", "ms_ssim"):
        assert np.isfinite(r["ae_only_test"][key])
        assert np.isfinite(r["with_si_test"][key])
    assert r["with_si_test"]["real_bpp"] > 0
    # the warm start: phase 1's scored AE partitions, a seeded siNet
    phase1 = os.path.join(out, "weights", r["phase1"]["model_name"])
    model = build_model(ae.replace(AE_only=False), pc, device="cpu")
    port_ckpt.load_state(model, port_ckpt.restore_partitions(
        phase1, port_ckpt.state_from_model(model), port_ckpt.AE_PARTITIONS))
    for k, v in model.state_dict().items():
        assert torch.equal(restored[2][k], v), k
    assert any(k.startswith("sinet.") for k in restored[2])

    r2 = synthetic_rd.run_3phase(ae, pc, out, phase1_steps=3,
                                 phase2_steps=2, max_test_images=1,
                                 device="cpu", on_restore=on_restore)
    assert r2["phase1"] == r["phase1"]               # from the marker
    assert r2["phase2"]["steps"] == 1                # budget spent: min 1
    with open(os.path.join(out, "rd_synthetic.json")) as f:
        assert json.load(f)["phase2"]["steps"] == 1


def test_the_sweep_runs_each_point_on_the_cpu(split, tmp_path,
                                              monkeypatch):
    ae, pc = split
    files = []
    real_run = port_main.run

    def spy(*args, **kwargs):
        path = os.path.join(str(tmp_path), "rd_curve.json")
        files.append(os.path.exists(path) and len(json.load(open(path))))
        return real_run(*args, **kwargs)

    monkeypatch.setattr(port_main, "run", spy)
    points = rd_sweep.sweep(ae.replace(test_model=True), pc,
                            out_root=str(tmp_path), targets=(0.02, 0.08),
                            max_steps=1, max_val_batches=1,
                            max_test_images=1, device="cpu")
    assert files == [False, 1]
    with open(tmp_path / "rd_curve.json") as f:
        assert json.load(f) == points
    for point, bpp in zip(points, (0.02, 0.08)):
        assert point["target_bpp"] == bpp
        assert point["H_target"] == bpp * 64.0 / ae.num_chan_bn
        assert point["steps"] == 1 and np.isfinite(point["psnr"])


def _trained(ae, pc, out, max_steps, monkeypatch, fail_at=None):
    """Train with profile_dir; -> (profiler, the last logged step when the
    profiler stopped)."""
    made, at_stop = [], []
    real_init, real_stop = (profiling.StepProfiler.__init__,
                            profiling.StepProfiler.stop)
    log = os.path.join(out, "log.jsonl")

    def init(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)

    def stop(self):
        if self.active and os.path.exists(log):
            with open(log) as f:
                at_stop.append(json.loads(f.read().splitlines()[-1])["step"])
        real_stop(self)

    monkeypatch.setattr(profiling.StepProfiler, "__init__", init)
    monkeypatch.setattr(profiling.StepProfiler, "stop", stop)
    exp = port_main.Experiment(ae.replace(show_every=1), pc, out_root=out,
                               device="cpu")
    if fail_at is not None:
        real_step, calls = exp.train_step, []

        def failing(x, y):
            calls.append(1)
            if len(calls) > fail_at:
                raise RuntimeError("boom")
            return real_step(x, y)
        exp.train_step = failing
    exp.train(max_steps=max_steps, max_val_batches=1, log_path=log,
              profile_dir=os.path.join(out, "trace"))
    return made[0], at_stop


@pytest.mark.parametrize("max_steps,window,drained", [
    (10, [5, 6, 7], 8),      # the in-flight step 7 is processed first
    (4, [1, 2, 3], None),    # clamped into a short run, stopped in finally
])
def test_train_traces_its_window(split, tmp_path, monkeypatch, max_steps,
                                 window, drained):
    ae, pc = split
    ae = ae.replace(iterations=100, validate_every=100)
    prof, at_stop = _trained(ae, pc, str(tmp_path), max_steps, monkeypatch)
    assert not prof.active and prof.trace_path is not None
    assert (prof.start_step, prof.stop_step) == (window[0], window[-1] + 1)
    summary = profiling.trace_summary(prof.trace_path)
    assert summary["annotations"] == window
    if drained is not None:
        assert at_stop == [drained]
    else:
        # the loop ended inside the window: every step was processed before
        # the finally stopped the profiler
        assert at_stop == [max_steps]


def test_a_crash_in_the_window_still_writes_the_trace(split, tmp_path,
                                                      monkeypatch):
    ae, pc = split
    ae = ae.replace(iterations=100, validate_every=100)
    with pytest.raises(RuntimeError, match="boom"):
        _trained(ae, pc, str(tmp_path), 10, monkeypatch, fail_at=6)
    (trace,) = os.listdir(tmp_path / "trace")
    summary = profiling.trace_summary(str(tmp_path / "trace" / trace))
    assert summary["annotations"] == [5, 6]
    assert summary["device_events"] == 0           # a CPU run


def test_the_clis_run_on_the_cpu(split, tmp_path):
    """`python -m dsin_tpu_torch.eval.synthetic_rd`, `.eval.rd_sweep` and
    `.main --profile_dir --replicate_to` with `--device cpu`."""
    ae, pc = split
    (tmp_path / "ae").write_text(str(ae.replace(iterations=100)))
    (tmp_path / "pc").write_text(str(pc))
    cfgs = ["-ae_config", str(tmp_path / "ae"), "-pc_config",
            str(tmp_path / "pc")]
    r = synthetic_rd.main(cfgs + [
        "--out_root", str(tmp_path / "rd"), "--phase1_steps", "1",
        "--phase2_steps", "1", "--max_test_images", "1", "--device", "cpu"])
    assert r["phase1"]["steps"] == r["phase2"]["steps"] == 1
    assert os.path.exists(tmp_path / "rd" / "rd_synthetic.json")
    rd_sweep.main(cfgs + ["--out_root", str(tmp_path / "sweep"),
                          "--targets", "0.02", "--max_steps", "1",
                          "--device", "cpu"])
    with open(tmp_path / "sweep" / "rd_curve.json") as f:
        assert [p["target_bpp"] for p in json.load(f)] == [0.02]
    port_main.main(cfgs + ["--out_root", str(tmp_path / "train"),
                           "--max_steps", "4", "--max_val_batches", "1",
                           "--profile_dir", str(tmp_path / "trace"),
                           "--replicate_to", str(tmp_path / "peer"),
                           "--device", "cpu"])
    (trace,) = os.listdir(tmp_path / "trace")
    assert profiling.trace_summary(str(tmp_path / "trace" / trace))[
        "annotations"] == [1, 2, 3]
    (replica,) = [d for d in os.listdir(tmp_path / "peer")
                  if ".prev-" not in d]
    assert port_ckpt.load_manifest(str(tmp_path / "peer" / replica)) == \
        port_ckpt.load_manifest(str(tmp_path / "train" / "weights" /
                                    replica))
