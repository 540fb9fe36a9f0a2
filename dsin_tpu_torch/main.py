"""Train / validate / test orchestration of DSIN and its CLI (counterpart of
the JAX package's `main.py`).

Parse the two config files, build the model (seeded weights) and its
two-group optimizer (`train/optim.py`), restore the configured checkpoint
(`load_model`, with `load_train_step` also the optimizer state and step, and
the best validation loss from `meta.json`), then:

* `train_model`: the fetch -> step -> validate loop over random crops of the
  train split (`data/loader.py`, prefetched on a thread): one
  `train/step.make_train_step` step per batch on one device, the metrics of
  step j read after step j+1 is enqueued, validation on center crops of the
  val split at `crop_size` under the training prior (the interval shrinks
  in the last half of training), the best-val checkpoint with its
  `opt_state.msgpack` and sidecars, periodic checkpoints
  (`checkpoint_every`), an emergency checkpoint on any exception, a
  divergence guard and an optional stop once the rate target is met. A
  restored step continues the numbering.
* `test_model`: after training, the best-val checkpoint is restored
  (`restore_best_for_test`); then the test split through the eval forward
  (`train/step.py make_inference_step`): center crops at `eval_crop_size`,
  one image at a time under the Gaussian prior (as its factors, built once
  per `Experiment`), reconstruction PNGs and per-image score lists
  (`eval/reporting.py`). With `--real_bpp` each bottleneck is also coded by
  the rANS codec (`coding/codec.py`: on the card in mode 3, through the
  probclass front kernel; on the CPU in mode 2, the JAX package's bytes)
  and the stream's bits per pixel are scored beside the estimate.

`profile_dir` traces a window of 3 warm train steps with `torch.profiler`
(`utils/profiling.py`); `replicate_to` copies each best-val checkpoint to
`<replicate_to>/<model_name>`, CRC-checked on both sides
(`train/checkpoint.replicate_checkpoint`).

More than one device (`parallel/`), one process per device: with a
process group of several ranks (`--distributed`, from torchrun's
environment) or `spatial_shards > 1`, the run trains over a (data, spatial)
mesh built as the JAX package builds it. `spatial_shards > 1` takes the
width-sharded step, its data axis the largest divisor of `batch_size` that
fits the ranks left (`spatial_shards` above the ranks raises the JAX
package's ValueError, one process included); otherwise every rank is on the
data axis when `batch_size` splits over them. Each rank loads the rows of
its data index (the loader's `host_id` its data index, `num_hosts` the
data axis), so every spatial rank of a data row sees the same pairs in the
same order, and its batch is `batch_size` / data ranks. Rank 0 alone
writes: checkpoints, sidecars, logs, traces, replicas, and it alone runs
the test split (one process per device would otherwise write the same
files N times; the JAX package's one process writes once). Ranks past the
mesh are idle. `save_plots` is not ported and raises NotImplementedError
naming its reason.

CLI:
    python -m dsin_tpu_torch.main -ae_config <path> -pc_config <path> \
        [--out_root DIR] [--data_root DIR] [--max_steps N] \
        [--max_val_batches N] [--max_test_images N] [--real_bpp] \
        [--profile_dir DIR] [--replicate_to DIR] [--device cpu]
    torchrun --nproc_per_node=N -m dsin_tpu_torch.main --distributed \
        [--backend nccl|gloo] [--device cuda|cuda:0|cpu] ...
"""

from __future__ import annotations

import argparse
import collections
import os
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from dsin_tpu_torch.coding.loader import make_codec
from dsin_tpu_torch.config import Config, parse_config_file
from dsin_tpu_torch.data.loader import PairDataset, Prefetcher
from dsin_tpu_torch.data.manifest import read_pair_manifest
from dsin_tpu_torch.eval.reporting import (ScoreLists, image_output_path,
                                           save_image)
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.parallel import data_parallel as dp
from dsin_tpu_torch.parallel import mesh as mesh_lib
from dsin_tpu_torch.runtime import config_path
from dsin_tpu_torch.train import checkpoint as ckpt_lib
from dsin_tpu_torch.train import optim as optim_lib
from dsin_tpu_torch.train import step as step_lib
from dsin_tpu_torch.utils.logging import JsonlLogger, StepTimer, color_print
from dsin_tpu_torch.utils.profiling import StepProfiler
from dsin_tpu_torch.utils.signals import install_interrupt_handlers

#: train-split size when the manifest is missing (KITTI stereo's 1576 pairs)
DEFAULT_NUM_TRAIN_IMGS = 1576


def get_validate_every(iteration: int, total_iterations: int,
                       validate_every: int,
                       decrease_val_steps: bool) -> int:
    """The validation interval: halved after half the iterations, quartered
    after three quarters (late improvements are rarer, so best-val
    checkpointing samples finer)."""
    if not decrease_val_steps:
        return validate_every
    if iteration >= (3 * total_iterations) // 4:
        return max(validate_every // 4, 1)
    if iteration >= total_iterations // 2:
        return max(validate_every // 2, 1)
    return validate_every


class Experiment:
    """Owns the model, its optimizer, the steps and the datasets of one
    run. The train step, the validation step and the training prior exist
    only when the config trains (`train_model`). `mesh` is the run's
    (data, spatial) mesh, or None on one device (module docstring); a rank
    past the mesh is `idle` and holds nothing else."""

    def __init__(self, ae_config: Config, pc_config: Config,
                 out_root: str = ".", seed: int = 0, device="cuda",
                 replicate_to: Optional[str] = None):
        self.ae_config = ae_config
        self.pc_config = pc_config
        self.out_root = out_root
        self.seed = seed
        #: peer-visible root each best-val save is replicated to, as
        #: <replicate_to>/<model_name> (None: off)
        self.replicate_to = replicate_to
        self.rank, world = mesh_lib.world()
        spatial = int(ae_config.get("spatial_shards", 1) or 1)
        if spatial > world:
            raise ValueError(f"spatial_shards={spatial} exceeds the {world} "
                             f"available devices")
        self.mesh = None
        if spatial > 1:
            data_par = mesh_lib.data_axis_size(ae_config.batch_size, world,
                                               spatial)
            self.mesh = mesh_lib.make_mesh(num_devices=data_par * spatial,
                                           spatial=spatial)
        elif world > 1:
            if ae_config.batch_size % world:
                raise ValueError(
                    f"batch_size {ae_config.batch_size} does not split over "
                    f"the {world} ranks: run batch_size / ranks rows a rank, "
                    f"or fewer ranks")
            self.mesh = mesh_lib.make_mesh()
        if self.mesh is not None:
            color_print(
                f"mesh: data={self.mesh.shape['data']} x spatial="
                f"{self.mesh.shape['spatial']} ({self.mesh.size}/{world} "
                f"ranks; data axis auto-sized to the largest divisor of "
                f"batch_size={ae_config.batch_size} that fits the remaining "
                f"ranks); rank {self.rank} at {self.mesh.coords}", "yellow")
        if self.idle:
            return      # a rank past the mesh builds nothing
        self.model = build_model(ae_config, pc_config, device=device,
                                 seed=seed)
        self.device = self.model.centers.device
        self.restore_ms = None
        self.restored_best_val = float("inf")

        train_manifest = os.path.join(ae_config.root_data,
                                      ae_config.file_path_train)
        self.num_train_imgs = (
            len(read_pair_manifest(train_manifest, root=ae_config.root_data))
            if os.path.exists(train_manifest) else DEFAULT_NUM_TRAIN_IMGS)
        self.optimizer = optim_lib.Optimizer(
            self.model, ae_config, pc_config, self.num_train_imgs)

        if self.mesh is not None:
            mesh_lib.replicate_state(self.mesh, self.model, self.optimizer)

        ph, pw = (int(v) for v in ae_config.y_patch_size)
        eh, ew = ae_config.get("eval_crop_size", ae_config.crop_size)
        # the priors travel as their factors (`sifinder.standard_prior`):
        # no (Hc, Wc, P) tensor, 33.3 GB at 1024x2048 with 16x32 patches
        self.eval_mask = (sifinder_lib.standard_prior(eh, ew, ph, pw)
                          if ae_config.use_gauss_mask else None)
        self.infer_step = step_lib.make_inference_step(
            self.model, si_mask=self.eval_mask)
        if ae_config.train_model:
            ch, cw = ae_config.crop_size
            self.train_mask = (sifinder_lib.standard_prior(ch, cw, ph, pw)
                               if ae_config.use_gauss_mask else None)
            grad_accum = int(ae_config.get("grad_accum_steps", 1) or 1)
            if grad_accum > 1:
                color_print(
                    f"grad_accum_steps={grad_accum}: BatchNorm statistics "
                    f"and the rate hinge are evaluated per micro-batch "
                    f"(see the JAX package's train/step.py on when this "
                    f"differs from the full-batch step)", "yellow")
            if self.mesh is None:
                self.train_step = step_lib.make_train_step(
                    self.model, self.optimizer, si_mask=self.train_mask,
                    grad_accum=grad_accum)
                self.val_step = step_lib.make_eval_step(
                    self.model, si_mask=self.train_mask)
            elif spatial > 1:
                self.train_step = dp.make_spatial_train_step(
                    self.model, self.optimizer, self.mesh, ch, cw,
                    grad_accum=grad_accum)
                self.val_step = dp.make_spatial_eval_step(
                    self.model, self.mesh, ch, cw)
            else:
                self.train_step = dp.make_sharded_train_step(
                    self.model, self.optimizer, self.mesh,
                    si_mask=self.train_mask, grad_accum=grad_accum)
                self.val_step = dp.make_sharded_eval_step(
                    self.model, self.mesh, si_mask=self.train_mask)

        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.model_name = ckpt_lib.model_name_for(ae_config, stamp)
        self.weights_root = os.path.join(out_root, "weights")
        self.ckpt_dir = os.path.join(self.weights_root, self.model_name)
        self.images_dir = os.path.join(out_root, "images", self.model_name)

    @property
    def step(self) -> int:
        return self.optimizer.step

    @property
    def writer(self) -> bool:
        """Whether this rank writes (rank 0 of a mesh, or the one process)."""
        return self.rank == 0

    @property
    def idle(self) -> bool:
        """A rank past the mesh: it trains and tests nothing."""
        return self.mesh is not None and not self.mesh.member

    def _data_axis(self):
        """(this rank's data index, the data axis) of the loader's
        sharding."""
        if self.mesh is None:
            return 0, 1
        return self.mesh.data_index, self.mesh.shape["data"]

    # -- data ---------------------------------------------------------------

    def _split_pairs(self, split: str) -> list:
        cfg = self.ae_config
        manifest = os.path.join(cfg.root_data,
                                getattr(cfg, f"file_path_{split}"))
        return read_pair_manifest(manifest, root=cfg.root_data)

    def _dataset(self, split: str, train: bool) -> PairDataset:
        """Train and val: this rank's data index's pairs, batch_size / data
        ranks a batch; test: every pair, one at a time (rank 0 tests)."""
        cfg = self.ae_config
        pairs = self._split_pairs(split)
        crop = (cfg.crop_size if train or split == "val"
                else cfg.get("eval_crop_size", cfg.crop_size))
        host, hosts = self._data_axis() if train or split == "val" else (0, 1)
        return PairDataset(
            pairs, crop_size=crop,
            batch_size=cfg.batch_size // hosts if train or split == "val"
            else 1, train=train, num_crops_per_img=cfg.num_crops_per_img,
            do_flips=cfg.get("do_flips", True), host_id=host,
            num_hosts=hosts)

    # -- checkpoints --------------------------------------------------------

    def _manifest_extra(self) -> dict:
        """The trainer's identity in every checkpoint manifest: the
        pc-config hash a loader re-derives from its own config, and the
        init seed."""
        return {"pc_config_sha256": ckpt_lib.config_sha256(self.pc_config),
                "seed": self.seed}

    def _save(self, ckpt_dir: str, **kwargs) -> None:
        ckpt_lib.save_checkpoint(
            ckpt_dir, ckpt_lib.state_from_model(self.model,
                                                optimizer=self.optimizer),
            manifest_extra=self._manifest_extra(), **kwargs)

    def _restore(self, restore_fn, train_step: bool = False) -> None:
        """Restore through `restore_fn(template) -> state`; with
        `train_step`, the template holds the optimizer state and the
        restored one replaces it."""
        optimizer = self.optimizer if train_step else None
        state = restore_fn(ckpt_lib.state_from_model(
            self.model, self.step, optimizer))
        ckpt_lib.load_state(self.model, state, optimizer)

    def maybe_restore(self) -> None:
        cfg = self.ae_config
        self.restored_best_val = float("inf")
        if not cfg.load_model:
            return
        t0 = time.perf_counter()
        load_dir = os.path.join(self.weights_root, cfg.load_model_name)
        # a save killed between its swap renames leaves a complete rotated
        # `.prev-*` behind: resolve whichever complete checkpoint survives
        if not os.path.exists(os.path.join(load_dir, "meta.json")):
            load_dir = ckpt_lib.latest_checkpoint(load_dir) or load_dir
        resume = bool(cfg.load_train_step)
        self._restore(lambda s: ckpt_lib.restore_for_mode(load_dir, s, cfg),
                      train_step=resume)
        if resume:
            # a true resume of the same phase seeds best-val tracking, so
            # its first validation is not always an "improvement"; a phase
            # switch (AE-only weights warm-starting siNet training) changes
            # the loss, and the old best_val stays unused
            self.restored_best_val = float(
                ckpt_lib.load_meta(load_dir).get("best_val", float("inf")))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.restore_ms = 1e3 * (time.perf_counter() - t0)
        color_print(f"restored from {load_dir} (step {self.step}, best_val "
                    f"{self.restored_best_val})", "green")

    # -- train --------------------------------------------------------------

    def validate(self, val_batches: Iterator,
                 max_batches: Optional[int] = None) -> float:
        """The mean validation loss over the batches (each the global
        batch's on a mesh)."""
        losses = []
        for i, (x, y) in enumerate(val_batches):
            if max_batches is not None and i >= max_batches:
                break
            losses.append(float(self.val_step(x, y)["loss"]))
        if not losses:
            # inf never improves, so best-val checkpoints stop: say why
            color_print("validation saw ZERO batches (val split smaller "
                        "than batch_size?) - val_loss=inf, no best-val "
                        "checkpoint will be saved", "red")
            return float("inf")
        return float(np.mean(losses))

    def _validate_and_maybe_save(self, i: int, iterations: int,
                                 best_val: float, val_losses, logger,
                                 max_val_batches: Optional[int],
                                 force_save: bool = False) -> float:
        """One validation pass and best-val checkpointing; returns the new
        best_val. `force_save` writes the checkpoint without an improvement
        (the rate-target stop keeps the weights that meet the rate)."""
        cfg = self.ae_config
        with self._dataset("val", train=False) as val_ds:
            if self.mesh is not None:
                # every data rank runs the same number of batches (each one
                # collective): the smallest shard's, len(pairs) // ranks
                _, hosts = self._data_axis()
                fewest = ((len(self._split_pairs("val")) // hosts)
                          // val_ds.batch_size)
                max_val_batches = (fewest if max_val_batches is None
                                   else min(max_val_batches, fewest))
            val_loss = self.validate(val_ds.batches(loop=False),
                                     max_batches=max_val_batches)
        val_losses.append(val_loss)
        improved = val_loss < best_val
        color_print(f"[{i + 1}] val_loss={val_loss:.4f} "
                    f"(best {min(best_val, val_loss):.4f})",
                    "green" if improved else "yellow")
        logger.log(i + 1, {"val_loss": val_loss})
        if improved:
            best_val = val_loss
        if (improved or force_save) and cfg.get("save_model", True) \
                and self.writer:
            self._save(self.ckpt_dir, best_val=best_val)
            ckpt_lib.write_sidecars(
                self.weights_root, self.model_name, cfg, self.pc_config,
                iteration=i + 1, total_iterations=iterations,
                best_val=best_val)
            if self.replicate_to:
                ckpt_lib.replicate_checkpoint(
                    self.ckpt_dir,
                    os.path.join(self.replicate_to, self.model_name))
        return best_val

    def train(self, max_steps: Optional[int] = None,
              max_val_batches: Optional[int] = None,
              log_path: Optional[str] = None,
              profile_dir: Optional[str] = None,
              until_rate_target: bool = False,
              rate_window: int = 200) -> Dict[str, float]:
        """The fetch -> step -> validate loop; returns summary stats.
        `max_steps` counts the steps to run from the restored step (None:
        the config's iterations), `max_val_batches` bounds each validation.
        `profile_dir` traces 3 warm steps there (`utils/profiling.py`).

        `until_rate_target=True` stops once the mean H_soft over the last
        `rate_window` steps is at most H_target (the rate hinge's whole
        purpose), with a closing validation and a forced save.

        Metrics lag dispatch by one step: step i+1 is enqueued before step
        i's metrics are read on the host, so host work (batch decode,
        logging, the device-to-host copy) overlaps device work. So the
        rate-target stop overshoots by one step, and a validation or
        checkpoint at boundary j reads the state after step j+1."""
        if until_rate_target and rate_window < 1:
            raise ValueError(f"rate_window must be >= 1, got {rate_window}")
        # SIGINT may be inherited ignored and SIGTERM kills without
        # unwinding: both must reach the emergency save below
        install_interrupt_handlers()
        cfg = self.ae_config
        start = min(self.step, cfg.iterations)
        iterations = (min(cfg.iterations, start + max_steps)
                      if max_steps else cfg.iterations)
        train_ds = self._dataset("train", train=True)
        train_it = Prefetcher(train_ds.batches())
        logger = JsonlLogger((log_path or os.path.join(
            self.out_root, "logs", f"{self.model_name}.jsonl"))
            if self.writer else None)
        timer = StepTimer()
        # clamp the trace window into short or resumed runs, so that
        # profile_dir always captures something (past the first steps'
        # cuDNN plans and kernel builds where it can); rank 0 traces
        remaining = iterations - start
        profiler = StepProfiler(
            profile_dir if self.writer else None,
            start_step=start + min(5, max(remaining - 3, 0)),
            device=self.device)
        # the step before which the trace window's last step is drained:
        # the same on every rank, as a validation there is collective
        drain_at = profiler.stop_step if profile_dir else None
        checkpoint_every = cfg.get("checkpoint_every", None)
        best_val = self.restored_best_val
        accum: Dict[str, float] = {}
        n_accum = 0
        val_losses = []
        h_recent: "collections.deque" = collections.deque(maxlen=rate_window)
        # divergence guard: stop when the val loss sits above
        # divergence_factor x best_val for divergence_patience consecutive
        # validations (0 disables); the best-val checkpoint keeps the run's
        # artifact
        div_factor = float(cfg.get("divergence_factor", 1.5))
        div_patience = int(cfg.get("divergence_patience", 3) or 0)
        div_bad = 0
        diverged = False

        def process(j, metrics):
            """Host handling of step j's metrics (step j+1 may already be
            enqueued). Returns whether an early stop fired."""
            nonlocal accum, n_accum, best_val, div_bad, diverged
            timer.tick()
            for k in ("loss", "bpp", "H_real", "d_loss", "si_l1"):
                accum[k] = accum.get(k, 0.0) + float(metrics[k])
            n_accum += 1

            if until_rate_target:
                h_recent.append(float(metrics["H_soft"]))
                if (len(h_recent) == rate_window
                        and float(np.mean(h_recent)) <= cfg.H_target):
                    color_print(
                        f"[{j + 1}] rate target reached: mean H_soft over "
                        f"the last {rate_window} steps "
                        f"{float(np.mean(h_recent)):.4f} <= H_target "
                        f"{cfg.H_target}", "green", bold=True)
                    best_val = self._validate_and_maybe_save(
                        j, iterations, best_val, val_losses, logger,
                        max_val_batches, force_save=True)
                    return True

            if (j + 1) % cfg.show_every == 0 or j + 1 == iterations:
                means = {k: v / n_accum for k, v in accum.items()}
                accum, n_accum = {}, 0
                ips = timer.images_per_sec(cfg.batch_size)
                color_print(
                    f"[{j + 1}/{iterations}] loss={means['loss']:.4f} "
                    f"bpp={means['bpp']:.4f} d={means['d_loss']:.4f} "
                    f"{ips:.2f} img/s", "cyan")
                logger.log(j + 1, means, images_per_sec=ips)

            # a periodic (not best-val) checkpoint bounds the work a crash
            # loses
            if checkpoint_every and (j + 1) % checkpoint_every == 0 \
                    and self.writer:
                self._save(os.path.join(self.ckpt_dir, "periodic"),
                           extra_meta={"kind": "periodic"})

            ve = get_validate_every(j, iterations, cfg.validate_every,
                                    cfg.get("decrease_val_steps", True))
            if (j + 1) % ve == 0 or j + 1 == iterations:
                best_val = self._validate_and_maybe_save(
                    j, iterations, best_val, val_losses, logger,
                    max_val_batches)
                val_loss = val_losses[-1]
                # only finite over finite counts: an inf val_loss means an
                # empty val split (its own warning), not divergence
                if (div_patience and np.isfinite(val_loss)
                        and np.isfinite(best_val)
                        and val_loss > div_factor * best_val):
                    div_bad += 1
                    if div_bad >= div_patience:
                        diverged = True
                        color_print(
                            f"[{j + 1}] DIVERGENCE STOP: val_loss above "
                            f"{div_factor:g}x best_val ({best_val:.4f}) for "
                            f"{div_bad} consecutive validations; the "
                            f"best-val checkpoint is the run's artifact",
                            "red", bold=True)
                        return True
                else:
                    div_bad = 0
            return False

        pending = None   # (step index, metrics on the device)
        try:
            for i in range(start, iterations):
                x, y = next(train_it)
                # drain the in-flight step before the trace window would
                # close: with the lag-1 loop the last traced step could
                # otherwise still be running when the profiler stops
                if pending is not None and i == drain_at:
                    if process(*pending):
                        pending = None
                        break
                    pending = None
                profiler.step(i)
                with profiler.annotation(i):
                    _, metrics = self.train_step(x, y)
                if pending is not None and process(*pending):
                    pending = None
                    break
                pending = (i, metrics)
            if pending is not None:
                process(*pending)
        except BaseException as e:
            # emergency save of the in-flight state; BaseException, so that
            # Ctrl-C and SIGTERM (KeyboardInterrupt) reach it too. Guarded:
            # a save that raises must not mask the original error. With the
            # lag-1 loop a crash can arrive before the completed step was
            # processed, hence `pending`.
            if (cfg.get("save_model", True) and self.writer
                    and (timer.total_steps > 0 or pending is not None)
                    and not isinstance(e, GeneratorExit)):
                emergency = os.path.join(self.ckpt_dir, "emergency")
                try:
                    self._save(emergency, extra_meta={"kind": "emergency",
                                                      "error": repr(e)})
                    color_print(f"crash at step {self.step}; state saved to "
                                f"{emergency}", "red", bold=True)
                except Exception as save_err:  # noqa: BLE001
                    color_print(f"crash AND emergency save failed "
                                f"({save_err!r}); state lost", "red",
                                bold=True)
            raise
        finally:
            profiler.stop()
            logger.close()
            train_ds.close()

        return {"steps": timer.total_steps, "best_val": best_val,
                "last_val": val_losses[-1] if val_losses else float("inf"),
                "diverged_stop": diverged,
                "images_per_sec": timer.images_per_sec(cfg.batch_size)}

    def restore_best_for_test(self, extra_candidates=()) -> Optional[str]:
        """Restore the best-val checkpoint among this run's ckpt_dir and
        `extra_candidates` (resolved through `.prev-*`; unreadable meta
        skipped), unless the live weights already are it: the test scores
        what the run ships, not a training tail that may have drifted past
        its best validation. Returns the restored dir or None."""
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
        color_print(f"test restores the best-val checkpoint {best_dir} "
                    f"(step {best_meta.get('step')}, val {best_val}) over "
                    f"the last training iterate", "yellow", bold=True)
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
        image's inputs, outputs, scores, stream (None without `real_bpp`)
        and stage times."""
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
            color_print(f"test means: {means}", "magenta", bold=True)
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
            measured = stream = None
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
                    "stream": stream,
                    "ms": {"forward": 1e3 * (t1 - t0),
                           "codec_encode": 1e3 * (t2 - t1),
                           "scoring": 1e3 * (t3 - t2)}})
            print(f"test[{idx}] bpp={bpp:.4f} psnr={scores['psnr']:.2f} "
                  f"msssim={scores['ms_ssim']:.4f}", flush=True)


def run(ae_config: Config, pc_config: Config, out_root: str = ".",
        max_steps: Optional[int] = None,
        max_val_batches: Optional[int] = None,
        max_test_images: Optional[int] = None,
        profile_dir: Optional[str] = None, real_bpp: bool = False,
        replicate_to: Optional[str] = None, device="cuda", seed: int = 0,
        on_image: Optional[Callable] = None) -> Dict[str, float]:
    """Config-driven orchestration: restore, train, then test the best-val
    checkpoint (on a mesh: every member rank trains, rank 0 tests, a rank
    past the mesh returns at once)."""
    exp = Experiment(ae_config, pc_config, out_root=out_root, seed=seed,
                     device=device, replicate_to=replicate_to)
    results: Dict[str, float] = {}
    if exp.idle:
        return results
    exp.maybe_restore()
    if ae_config.train_model:
        results.update(exp.train(max_steps=max_steps,
                                 max_val_batches=max_val_batches,
                                 profile_dir=profile_dir))
    if ae_config.test_model and exp.writer:
        if ae_config.train_model:
            # never score the in-memory training tail: test what the run
            # ships
            exp.restore_best_for_test()
        results.update(exp.test(max_images=max_test_images,
                                real_bpp=real_bpp, on_image=on_image))
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dsin_tpu_torch trainer")
    p.add_argument("-ae_config", default=config_path("ae_kitti_stereo"))
    p.add_argument("-pc_config", default=config_path("pc_default"))
    p.add_argument("--out_root", default=".")
    p.add_argument("--data_root", default=None,
                   help="override ae config root_data")
    p.add_argument("--max_steps", type=int, default=None,
                   help="train steps to run from the restored step")
    p.add_argument("--max_val_batches", type=int, default=None,
                   help="batches per validation pass")
    p.add_argument("--max_test_images", type=int, default=None)
    p.add_argument("--real_bpp", action="store_true",
                   help="at test time, also encode each bottleneck with the "
                        "rANS codec and score the stream's bits per pixel")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of 3 warm train steps "
                        "there")
    p.add_argument("--replicate_to", default=None,
                   help="peer-visible root to replicate every best-val "
                        "checkpoint to (CRC-checked on both sides); the "
                        "copy lands at <replicate_to>/<model_name>")
    p.add_argument("--distributed", action="store_true",
                   help="one rank of a process group (torchrun's RANK, "
                        "WORLD_SIZE, LOCAL_RANK and MASTER_ADDR/PORT): "
                        "trains over the (data, spatial) mesh, rank 0 "
                        "writes")
    p.add_argument("--backend", default="nccl", choices=mesh_lib.BACKENDS,
                   help="with --distributed: nccl (one card a rank) or gloo "
                        "(the CPU, or ranks sharing a card: pass --device "
                        "cuda:0); never switched")
    p.add_argument("--init_method", default=None,
                   help="with --distributed: the rendezvous (default "
                        "env://; or file:///path)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = args.device
    if args.distributed:
        device = mesh_lib.init_distributed(args.backend, args.device,
                                           init_method=args.init_method)
    try:
        ae_config = parse_config_file(args.ae_config)
        pc_config = parse_config_file(args.pc_config)
        if args.data_root:
            ae_config = ae_config.replace(root_data=args.data_root)
        results = run(ae_config, pc_config, out_root=args.out_root,
                      max_steps=args.max_steps,
                      max_val_batches=args.max_val_batches,
                      max_test_images=args.max_test_images,
                      profile_dir=args.profile_dir, real_bpp=args.real_bpp,
                      replicate_to=args.replicate_to, device=device)
    finally:
        if args.distributed:
            dist.destroy_process_group()
    color_print(f"done: {results}", "green", bold=True)


if __name__ == "__main__":
    main()
