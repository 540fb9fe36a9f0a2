"""The three-phase rate-distortion run on the synthetic stereo corpus
(counterpart of the JAX package's `eval/synthetic_rd.py`):

  phase 1  train AE-only                        -> best-val checkpoint
  (test)   AE-only inference on the test split  -> RD point without SI
  phase 2  warm-start the AE, train with siNet  -> best-val checkpoint
  (test)   SI inference, real bpp               -> RD point with SI

and writes `rd_synthetic.json` with both points (bpp / PSNR / MS-SSIM means)
and the run's metadata. The gap between the two points is the value of
side information.

Both phases are retry-safe, as in the JAX package: a finished phase 1
leaves `phase1_done.json` and is skipped on a retry; an interrupted phase
resumes from the furthest checkpoint a prior attempt left
(`_latest_resumable`), with the phase's total step budget kept.

CLI (the corpus, 40 / 8 / 8 pairs at the eval crop, is generated when
missing):
    python -m dsin_tpu_torch.eval.synthetic_rd --out_root DIR \
        [-ae_config <path>] [--data_dir DIR] [--phase1_steps N] \
        [--phase2_steps N] [--max_test_images N] [--H_target H | \
        --target_bpp B] [--iterations N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.runtime import config_path
from dsin_tpu_torch.train import checkpoint as ckpt_lib
from dsin_tpu_torch.utils.logging import color_print

#: the generated corpus: train / val / test pairs at the eval crop
CORPUS_PAIRS = (40, 8, 8)


def _latest_resumable(out_root: str, ae_config, ae_only: bool):
    """The newest prior attempt of this phase (same target and mode) with
    the highest-step restorable checkpoint under out_root/weights: (its
    name relative to the weights root, possibly '<dir>/periodic' or
    '<dir>/emergency' or a `.prev-*` left by a kill, step), or (None, 0)."""
    weights = os.path.join(out_root, "weights")
    # the prefix comes from the one naming authority: an empty timestamp
    # gives exactly 'target_bpp<x>_<mode>_'
    prefix = ckpt_lib.model_name_for(ae_config.replace(AE_only=ae_only), "")
    best_name, best_step = None, 0
    if not os.path.isdir(weights):
        return None, 0
    for d in sorted(os.listdir(weights)):
        if not d.startswith(prefix):
            continue
        for sub in ("", "periodic", "emergency"):
            cand = os.path.join(weights, d, sub) if sub else \
                os.path.join(weights, d)
            name = os.path.join(d, sub) if sub else d
            # a save killed between its swap renames leaves only a rotated
            # `.prev-*` sibling: still a resumable checkpoint
            if not os.path.exists(os.path.join(cand, "meta.json")):
                resolved = ckpt_lib.latest_checkpoint(cand)
                if resolved is None:
                    continue
                cand, name = resolved, os.path.relpath(resolved, weights)
            try:
                step = int(ckpt_lib.load_meta(cand)["step"])
            except (OSError, KeyError, ValueError):
                continue
            if step > best_step:
                best_name, best_step = name, step
    return best_name, best_step


def _prior_best_dir(out_root: str, prior: Optional[str]):
    """The candidate for `Experiment.restore_best_for_test` on a resumed
    phase: the prior attempt's best-val dir (the parent of a periodic or
    emergency checkpoint `_latest_resumable` returned)."""
    if not prior:
        return ()
    root = prior
    for sub in ("periodic", "emergency"):
        if root.endswith("/" + sub):
            root = root[: -len(sub) - 1]
    return (os.path.join(out_root, "weights", root),)


def _ensure_restorable(exp, kind: str) -> None:
    """A resumed tail that never beats the restored best_val saves nothing
    under the new model_name: the dir must hold the final state all the
    same."""
    if not os.path.exists(os.path.join(exp.ckpt_dir, "meta.json")):
        exp._save(exp.ckpt_dir, extra_meta={"kind": kind})


def run_3phase(ae_config, pc_config, out_root: str,
               phase1_steps=None, phase2_steps=None,
               max_test_images=None, phase1_until_target=False,
               rate_window=200, device="cuda", seed: int = 0,
               on_restore: Optional[Callable] = None,
               on_image: Optional[Callable] = None) -> dict:
    """Phase 1, its test, phase 2 and its real-bpp test on `device` (the
    card by default), weights from `seed`; returns and writes the results.
    Phase 2 has no marker: its completion is `rd_synthetic.json`, and a
    retry after a crash in the closing test resumes phase 2 (at least 1
    step) and tests again. Periodic checkpoints (every 2000 steps unless
    the config says otherwise, an explicit "off" included) bound the work
    a retry redoes. `on_restore(phase, exp)` sees each phase's Experiment
    right after its restore, `on_image(exp, idx, record)` each test
    image (`Experiment.test`)."""
    from dsin_tpu_torch.main import Experiment

    t0 = time.time()
    os.makedirs(out_root, exist_ok=True)
    results = {"config": os.path.basename(
                   str(getattr(ae_config, "_name", "config"))),
               "crop": list(ae_config.crop_size),
               "eval_crop": list(ae_config.get("eval_crop_size",
                                               ae_config.crop_size)),
               "H_target": ae_config.H_target,
               "target_bpp": ae_config.H_target /
               (64.0 / ae_config.num_chan_bn)}
    ckpt_every = (ae_config.get("checkpoint_every")
                  if "checkpoint_every" in ae_config else 2000)

    def experiment(phase, cfg):
        exp = Experiment(cfg, pc_config, out_root=out_root, seed=seed,
                         device=device)
        exp.maybe_restore()
        if on_restore is not None:
            on_restore(phase, exp)
        return exp

    # -- phase 1: AE_only ---------------------------------------------------
    marker1 = os.path.join(out_root, "phase1_done.json")
    if os.path.exists(marker1):
        with open(marker1) as f:
            done = json.load(f)
        results["phase1"] = done["phase1"]
        results["ae_only_test"] = done["ae_only_test"]
        phase1_name = done["phase1"]["model_name"]
        color_print(f"phase 1 already complete ({phase1_name}); skipping",
                    "green")
    else:
        prior, prior_step = _latest_resumable(out_root, ae_config,
                                              ae_only=True)
        if prior:
            color_print(f"phase 1 resumes from {prior} (step {prior_step})",
                        "yellow")
        exp1 = experiment(1, ae_config.replace(
            AE_only=True, load_model=prior is not None,
            load_model_name=prior or "", load_train_step=prior is not None,
            train_model=True, test_model=False,
            checkpoint_every=ckpt_every))
        color_print(f"phase 1 (AE_only) -> {exp1.model_name}", "cyan",
                    bold=True)
        # max_steps counts the steps to run from the restored step: keep the
        # phase's total budget (at least 1: 0 would mean uncapped, and the
        # closing validation must still run)
        steps1 = (max(phase1_steps - prior_step, 1)
                  if prior and phase1_steps else phase1_steps)
        r1 = exp1.train(max_steps=steps1,
                        until_rate_target=phase1_until_target,
                        rate_window=rate_window)
        _ensure_restorable(exp1, "phase1_final")
        best1 = exp1.restore_best_for_test(
            extra_candidates=_prior_best_dir(out_root, prior))
        t1 = exp1.test(max_images=max_test_images, save_images=True,
                       on_image=on_image)
        # phase 2 warm-starts from the checkpoint this test scored: on a
        # resumed phase 1 that never beat the prior best, the prior dir
        phase1_name = (os.path.relpath(best1, exp1.weights_root)
                       if best1 else exp1.model_name)
        results["phase1"] = {"model_name": phase1_name, **r1}
        results["ae_only_test"] = t1
        with open(marker1, "w") as f:
            json.dump({"phase1": results["phase1"],
                       "ae_only_test": t1}, f, indent=2)

    # -- phase 2: warm-start the AE, fresh siNet ----------------------------
    # a resumed phase 2 restores siNet and the optimizer from the prior
    # attempt; a fresh one restores only the AE partitions from phase 1
    prior2, prior2_step = _latest_resumable(out_root, ae_config,
                                            ae_only=False)
    if prior2:
        color_print(f"phase 2 resumes from {prior2} (step {prior2_step})",
                    "yellow")
    # phase 2's guard is tighter than train()'s 1.5 / 3 default (the JAX
    # package's measured +siNet validation profile); the config wins
    exp2 = experiment(2, ae_config.replace(
        AE_only=False, load_model=True,
        load_model_name=prior2 or phase1_name,
        load_train_step=prior2 is not None, train_model=True,
        test_model=False, checkpoint_every=ckpt_every,
        divergence_factor=ae_config.get("divergence_factor", 1.3),
        divergence_patience=ae_config.get("divergence_patience", 2)))
    color_print(f"phase 2 (+siNet) -> {exp2.model_name}", "cyan", bold=True)
    steps2 = (max(phase2_steps - prior2_step, 1)
              if prior2 and phase2_steps else phase2_steps)
    r2 = exp2.train(max_steps=steps2)
    _ensure_restorable(exp2, "phase2_final")
    best2 = exp2.restore_best_for_test(
        extra_candidates=_prior_best_dir(out_root, prior2))
    t2 = exp2.test(max_images=max_test_images, save_images=True,
                   real_bpp=True, on_image=on_image)
    phase2_name = (os.path.relpath(best2, exp2.weights_root)
                   if best2 else exp2.model_name)
    results["phase2"] = {"model_name": phase2_name, **r2}
    results["with_si_test"] = t2
    results["wall_clock_s"] = round(time.time() - t0, 1)

    out_path = os.path.join(out_root, "rd_synthetic.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    color_print(f"3-phase RD evidence written to {out_path}", "green",
                bold=True)
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="synthetic 3-phase RD run")
    p.add_argument("-ae_config", default=config_path("ae_synthetic_stereo"))
    p.add_argument("-pc_config", default=config_path("pc_default"))
    p.add_argument("--out_root", required=True)
    p.add_argument("--data_dir", default=None,
                   help="synthetic corpus dir (generated if missing)")
    p.add_argument("--phase1_steps", type=int, default=None)
    p.add_argument("--phase2_steps", type=int, default=None)
    p.add_argument("--phase1_until_target", action="store_true",
                   help="stop phase 1 once the mean H_soft over "
                        "--rate_window steps reaches H_target; "
                        "--phase1_steps / iterations still cap it")
    p.add_argument("--rate_window", type=int, default=200)
    p.add_argument("--max_test_images", type=int, default=None)
    p.add_argument("--H_target", type=float, default=None,
                   help="override the config's rate target (bits per "
                        "bottleneck voxel; target_bpp = H_target / "
                        "(64 / num_chan_bn))")
    p.add_argument("--target_bpp", type=float, default=None,
                   help="rate target in bits per pixel, converted through "
                        "the config's num_chan_bn; exclusive with "
                        "--H_target")
    p.add_argument("--iterations", type=int, default=None,
                   help="override the config's iterations cap (train() "
                        "clamps --phase*_steps to it)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.H_target is not None and args.target_bpp is not None:
        p.error("--H_target and --target_bpp are mutually exclusive")
    return args


def configs_from_args(args):
    """The two configs the CLI runs: the overrides applied, and the data
    rewired to a synthetic corpus (generated when missing). Returns (ae,
    pc, corpus seconds: 0 when nothing was generated)."""
    from dsin_tpu_torch.eval.rd_sweep import h_target_for_bpp

    ae_config = parse_config_file(args.ae_config)
    pc_config = parse_config_file(args.pc_config)
    if args.H_target is not None:
        ae_config = ae_config.replace(H_target=args.H_target)
    if args.target_bpp is not None:
        ae_config = ae_config.replace(H_target=h_target_for_bpp(
            args.target_bpp, ae_config.num_chan_bn))
    if args.iterations is not None:
        ae_config = ae_config.replace(iterations=args.iterations)
    if args.data_dir:
        ae_config = ae_config.replace(root_data=args.data_dir)

    manifest = os.path.join(ae_config.root_data, ae_config.file_path_train)
    synth_manifest = os.path.join(ae_config.root_data,
                                  "synthetic_stereo_train.txt")
    if not os.path.exists(manifest) and os.path.exists(synth_manifest):
        # a synthetic corpus already lives here: rewire, do not regenerate
        ae_config = ae_config.replace(
            **{f"file_path_{split}": f"synthetic_stereo_{split}.txt"
               for split in ("train", "val", "test")})
        manifest = synth_manifest
    corpus_s = 0.0
    if not os.path.exists(manifest):
        from dsin_tpu_torch.data.synthetic import write_corpus
        eh, ew = ae_config.get("eval_crop_size", ae_config.crop_size)
        color_print(f"generating synthetic corpus in {ae_config.root_data}",
                    "yellow")
        t0 = time.perf_counter()
        manifests = write_corpus(ae_config.root_data, *CORPUS_PAIRS,
                                 height=eh, width=ew)
        corpus_s = time.perf_counter() - t0
        # point the config at the generated manifests: a config naming
        # KITTI manifests would otherwise not find them
        ae_config = ae_config.replace(
            **{f"file_path_{split}": os.path.basename(path)
               for split, path in manifests.items()})
    return ae_config, pc_config, corpus_s


def main(argv=None) -> dict:
    args = parse_args(argv)
    ae_config, pc_config, _ = configs_from_args(args)
    os.makedirs(args.out_root, exist_ok=True)
    return run_3phase(ae_config, pc_config, args.out_root,
                      phase1_steps=args.phase1_steps,
                      phase2_steps=args.phase2_steps,
                      max_test_images=args.max_test_images,
                      phase1_until_target=args.phase1_until_target,
                      rate_window=args.rate_window, device=args.device,
                      seed=args.seed)


if __name__ == "__main__":
    main()
