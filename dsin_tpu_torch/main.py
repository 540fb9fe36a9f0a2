"""The test run of DSIN: score a checkpoint on a test split (counterpart of
the JAX package's `main.py`, its test half).

Parse the two config files, build the model (seeded weights), restore the
configured checkpoint (`load_model`, `train/checkpoint.py`), then run the
test split through the eval forward (`train/step.py make_inference_step`):
center crops at `eval_crop_size` from a KITTI-format pair manifest, one
image at a time under the concrete Gaussian prior (checked once per
`Experiment`), reconstruction PNGs and per-image score lists
(`eval/reporting.py`). With `--real_bpp` each bottleneck is also coded by
the rANS codec (`coding/codec.py`: on the card in mode 3, through the
probclass front kernel; on the CPU in mode 2, the JAX package's bytes) and
the stream's bits per pixel are scored beside the estimate.

Training (`train_model = True`: its backward pass, optimizers and loop),
`--distributed`, `--profile_dir` and `save_plots` are not ported yet and
raise NotImplementedError.

CLI:
    python -m dsin_tpu_torch.main -ae_config <path> -pc_config <path> \
        [--out_root DIR] [--data_root DIR] [--max_test_images N] \
        [--real_bpp] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dsin_tpu_torch.coding.loader import make_codec
from dsin_tpu_torch.config import Config, parse_config_file
from dsin_tpu_torch.data.loader import PairDataset
from dsin_tpu_torch.data.manifest import read_pair_manifest
from dsin_tpu_torch.eval.reporting import (ScoreLists, image_output_path,
                                           save_image)
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.runtime import config_path
from dsin_tpu_torch.train import checkpoint as ckpt_lib
from dsin_tpu_torch.train import step as step_lib

def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} waits for training in the port ({ckpt_lib.TRAINING_ITEM})")


class Experiment:
    """Owns the model, the eval step and the datasets of one test run."""

    def __init__(self, ae_config: Config, pc_config: Config,
                 out_root: str = ".", seed: int = 0, device="cuda"):
        self.ae_config = ae_config
        self.pc_config = pc_config
        self.out_root = out_root
        self.seed = seed
        self.model = build_model(ae_config, pc_config, device=device,
                                 seed=seed)
        self.device = self.model.centers.device
        self.step = 0
        self.restore_ms = None

        ph, pw = (int(v) for v in ae_config.y_patch_size)
        eh, ew = ae_config.get("eval_crop_size", ae_config.crop_size)
        self.eval_mask = None
        self.mask_check_ms = 0.0
        if ae_config.use_gauss_mask:
            mask = torch.as_tensor(sifinder_lib.gaussian_position_mask(
                eh, ew, ph, pw), device=self.device)
            t0 = time.perf_counter()
            self.eval_mask = sifinder_lib.check_mask(mask, ph, pw)
            self.mask_check_ms = 1e3 * (time.perf_counter() - t0)
        self.infer_step = step_lib.make_inference_step(
            self.model, si_mask=self.eval_mask)

        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.model_name = ckpt_lib.model_name_for(ae_config, stamp)
        self.weights_root = os.path.join(out_root, "weights")
        self.ckpt_dir = os.path.join(self.weights_root, self.model_name)
        self.images_dir = os.path.join(out_root, "images", self.model_name)

    # -- data ---------------------------------------------------------------

    def _dataset(self, split: str, train: bool) -> PairDataset:
        cfg = self.ae_config
        manifest = os.path.join(cfg.root_data,
                                getattr(cfg, f"file_path_{split}"))
        pairs = read_pair_manifest(manifest, root=cfg.root_data)
        crop = (cfg.crop_size if train or split == "val"
                else cfg.get("eval_crop_size", cfg.crop_size))
        return PairDataset(
            pairs, crop_size=crop,
            batch_size=cfg.batch_size if train or split == "val" else 1,
            train=train, num_crops_per_img=cfg.num_crops_per_img,
            do_flips=cfg.get("do_flips", True))

    # -- restore ------------------------------------------------------------

    def _restore(self, restore_fn) -> None:
        state = restore_fn(ckpt_lib.state_from_model(self.model, self.step))
        ckpt_lib.load_state(self.model, state)
        self.step = int(state.step)

    def maybe_restore(self) -> None:
        cfg = self.ae_config
        if not cfg.load_model:
            return
        t0 = time.perf_counter()
        load_dir = os.path.join(self.weights_root, cfg.load_model_name)
        # a save killed between its swap renames leaves a complete rotated
        # `.prev-*` behind: resolve whichever complete checkpoint survives
        if not os.path.exists(os.path.join(load_dir, "meta.json")):
            load_dir = ckpt_lib.latest_checkpoint(load_dir) or load_dir
        self._restore(lambda s: ckpt_lib.restore_for_mode(load_dir, s, cfg))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.restore_ms = 1e3 * (time.perf_counter() - t0)
        print(f"restored from {load_dir} (step {self.step})", flush=True)

    def restore_best_for_test(self, extra_candidates=()) -> Optional[str]:
        """Restore the best-val checkpoint among this run's ckpt_dir and
        `extra_candidates` (resolved through `.prev-*`; unreadable meta
        skipped), unless the live weights already are it. Returns the
        restored dir or None."""
        best_dir, best_val, best_meta = None, float("inf"), None
        for cand in (self.ckpt_dir, *extra_candidates):
            if not os.path.exists(os.path.join(cand, "meta.json")):
                cand = ckpt_lib.latest_checkpoint(cand) or cand
            try:
                meta = ckpt_lib.load_meta(cand)
                val = float(meta["best_val"])
            except (OSError, KeyError, ValueError):
                continue
            if val < best_val:
                best_dir, best_val, best_meta = cand, val, meta
        if best_dir is None:
            return None
        if (best_dir == self.ckpt_dir
                and int(best_meta.get("step", -1)) == self.step):
            return None
        self._restore(lambda s: ckpt_lib.restore_partitions(
            best_dir, s, best_meta["partitions"]))
        print(f"test restores the best-val checkpoint {best_dir} (step "
              f"{best_meta.get('step')}, val {best_val})", flush=True)
        return best_dir

    # -- test ---------------------------------------------------------------

    def _bottleneck_codec(self):
        """The rANS codec over the model's context model and centers, on the
        model's device, for the measured-bitstream bpp, and its stream mode:
        mode 3 (the front kernel) on the card, mode 2 (numpy, the JAX
        package's bytes) on the CPU, where mode 3 would run the kernel's
        plain version."""
        mode = "wavefront_pl" if self.device.type == "cuda" \
            else "wavefront_np"
        return make_codec(self.model), mode

    def test(self, max_images: Optional[int] = None,
             save_images: bool = True, save_plots: bool = False,
             real_bpp: bool = False,
             on_image: Optional[Callable] = None) -> Dict[str, float]:
        """Test-split inference: reconstruction PNGs + per-image score
        lists. `real_bpp=True` also encodes each bottleneck and scores the
        stream's bits per pixel. `on_image(exp, idx, record)` sees each
        image's inputs, outputs, scores and stage times."""
        if save_plots:
            raise NotImplementedError(
                "save_plots needs matplotlib, which the port does not use "
                "(the panels are a JAX-package tool, eval/plots.py)")
        lists = ScoreLists(self.images_dir, self.model_name)
        codec = self._bottleneck_codec() if real_bpp else None
        test_ds = self._dataset("test", train=False)
        try:
            self._run_test_loop(test_ds, lists, codec, self.ae_config,
                                max_images, save_images, on_image)
        finally:
            test_ds.close()
        means = lists.means()
        if means:
            print(f"test means: {means}", flush=True)
        return means

    def _run_test_loop(self, test_ds, lists, codec, cfg, max_images,
                       save_images, on_image):
        clock = time.perf_counter
        for idx, (x, y) in enumerate(test_ds.batches(loop=False)):
            if max_images is not None and idx >= max_images:
                break
            t0 = clock()
            out = self.infer_step(x, y)
            # one pull of every output per image: the host boundary of the
            # loop (scoring and PNG writing are host work)
            out = {k: None if v is None else v.cpu().numpy()
                   for k, v in out.items()}
            t1 = clock()
            x_np = x[0]
            xsi = np.clip((out["x_with_si"] if not self.model.ae_only
                           else out["x_dec"])[0], 0, 255)
            y_syn = (np.clip(out["y_syn"][0], 0, 255)
                     if out["y_syn"] is not None else None)
            bpp = float(out["bpp"])
            measured = None
            if codec is not None:
                coder, mode = codec
                syms = np.transpose(out["symbols"][0], (2, 0, 1))
                stream = coder.encode(syms, mode=mode)
                measured = len(stream) * 8.0 / (x_np.shape[0]
                                                * x_np.shape[1])
            t2 = clock()
            scores = lists.add_image(x_np, xsi, bpp=bpp, y_syn=y_syn,
                                     patch_size=cfg.y_patch_size,
                                     real_bpp=measured)
            if save_images:
                save_image(xsi, image_output_path(self.images_dir, idx, bpp))
            lists.save()
            t3 = clock()
            if on_image is not None:
                on_image(self, idx, {
                    "x": x, "y": y, "out": out, "scores": scores,
                    "ms": {"forward": 1e3 * (t1 - t0),
                           "codec_encode": 1e3 * (t2 - t1),
                           "scoring": 1e3 * (t3 - t2)}})
            print(f"test[{idx}] bpp={bpp:.4f} psnr={scores['psnr']:.2f} "
                  f"msssim={scores['ms_ssim']:.4f}", flush=True)


def run(ae_config: Config, pc_config: Config, out_root: str = ".",
        max_test_images: Optional[int] = None, real_bpp: bool = False,
        device="cuda",
        on_image: Optional[Callable] = None) -> Dict[str, float]:
    """Config-driven orchestration of a test run; `train_model` raises."""
    if ae_config.train_model:
        raise _not_ported("train_model = True")
    exp = Experiment(ae_config, pc_config, out_root=out_root, device=device)
    exp.maybe_restore()
    results: Dict[str, float] = {}
    if ae_config.test_model:
        results.update(exp.test(max_images=max_test_images,
                                real_bpp=real_bpp, on_image=on_image))
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dsin_tpu_torch test run")
    p.add_argument("-ae_config", default=config_path("ae_kitti_stereo"))
    p.add_argument("-pc_config", default=config_path("pc_default"))
    p.add_argument("--out_root", default=".")
    p.add_argument("--data_root", default=None,
                   help="override ae config root_data")
    p.add_argument("--max_test_images", type=int, default=None)
    p.add_argument("--real_bpp", action="store_true",
                   help="at test time, also encode each bottleneck with the "
                        "rANS codec and score the stream's bits per pixel")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--profile_dir", default=None,
                   help="not ported: traces a few train steps")
    p.add_argument("--distributed", action="store_true",
                   help="not ported: multi-host training")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.distributed:
        raise _not_ported("--distributed")
    if args.profile_dir:
        raise _not_ported("--profile_dir")
    ae_config = parse_config_file(args.ae_config)
    pc_config = parse_config_file(args.pc_config)
    if args.data_root:
        ae_config = ae_config.replace(root_data=args.data_root)
    results = run(ae_config, pc_config, out_root=args.out_root,
                  max_test_images=args.max_test_images,
                  real_bpp=args.real_bpp, device=args.device)
    print(f"done: {results}", flush=True)


if __name__ == "__main__":
    main()
