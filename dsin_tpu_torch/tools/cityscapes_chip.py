"""Train the Cityscapes geometry on one card through the row-tiled search
(counterpart of the JAX package's `tools/cityscapes_chip.py`).

    python -m dsin_tpu_torch.tools.cityscapes_chip [--steps 3] \\
        [--crop 1024,2048] [--out F.json] [--seed N] [--device cpu]

`ae_cityscapes_stereo` + `pc_default` at the config's own operating point
(bfloat16 compute, remat, 16x32 patches) with `spatial_shards = 1` and
`sifinder_impl = 'tiled'`, batch 1, on the JAX tool's synthetic frames (a
sinusoid with N(0, 8) noise, the side frame shifted by 17 columns) at the
full 1024x2048 frame: Hc x Wc = 1009 x 2017 map positions for P = 4096
patches, so a materialized score map or (Hc, Wc, P) prior would be 33.3 GB.
The prior travels as its factors (`sifinder.standard_prior`) and the search
holds one row chunk of scores at a time (1.06 GB at 32 rows).

One warm-up step, then `--steps` timed steps. On
`torch.cuda.OutOfMemoryError`, and only on that, the attempt is recorded and
the next row chunk of `ROW_CHUNKS` is tried. The JSON report (the last line
of the output, and `--out` when given) lists the attempts with their row
chunk, ms per step, the search's ms inside each step (CUDA events around
the search, from the step's `on_search` hook), the first and last loss,
bpp, the trained parameters that did not move, and the peak device memory,
beside the card's name and power limit. Like every entry point of the port
it runs on the card and raises without one; `--device cpu` runs it on the
CPU (with `--crop` for a small frame), where times are host-clock times
(`clock: host`) and no device memory is read.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.runtime import config_path, resolve_device
from dsin_tpu_torch.train import optim as optim_lib
from dsin_tpu_torch.train import step as step_lib

ROW_CHUNKS = (32, 16, 8)
CROP = (1024, 2048)
NUM_TRAIN_IMGS = 100     # the JAX tool's optimizer schedule


class Trained(NamedTuple):
    """The attempt that fitted: its model after the timed steps, its AE
    config and its (x, y) frames on the model's device."""
    model: torch.nn.Module
    config: object
    x: torch.Tensor
    y: torch.Tensor


def card_name(dev: torch.device) -> str:
    """`nvidia-smi`'s name and power limit of the card, or 'cpu'."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def frames(crop_h: int, crop_w: int, seed: int = 0):
    """(x, y) float32 (1, crop_h, crop_w, 3) in [0, 255]: the JAX tool's
    synthetic stereo-like frames, x at shift 0, then y at shift 17."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:crop_h, 0:crop_w]

    def frame(shift):
        base = (128 + 80 * np.sin(2 * np.pi * (xx + shift) / 256)
                * np.cos(2 * np.pi * yy / 128))
        noise = rng.normal(0, 8, (crop_h, crop_w, 3))
        return np.clip(base[..., None] + noise, 0, 255).astype(
            np.float32)[None]

    x = frame(0)
    return x, frame(17)


def configs(crop, row_chunk: int):
    """ae_cityscapes_stereo on one card through the tiled search, and
    pc_default."""
    ae = parse_config_file(config_path("ae_cityscapes_stereo")).replace(
        spatial_shards=1, sifinder_impl="tiled", sifinder_row_chunk=row_chunk,
        crop_size=tuple(crop), eval_crop_size=tuple(crop))
    return ae, parse_config_file(config_path("pc_default"))


def _clock(dev: torch.device):
    """(mark, ms_between): CUDA events on the card, the host clock on the
    CPU."""
    if dev.type == "cuda":
        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return mark, lambda a, b: a.elapsed_time(b)
    return time.perf_counter, lambda a, b: 1e3 * (b - a)


def _attempt(ae, pc, x, y, steps: int, dev: torch.device, seed: int,
             record: dict) -> Trained:
    """Build, then one warm-up step and `steps` timed ones; fills `record`."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(ae, pc, device=dev, seed=seed)
    optimizer = optim_lib.Optimizer(model, ae, pc, NUM_TRAIN_IMGS)
    h, w = x.shape[1:3]
    ph, pw = (int(v) for v in ae.y_patch_size)
    mark, ms_between = _clock(dev)
    marks = {}
    step = step_lib.make_train_step(
        model, optimizer, si_mask=sifinder_lib.standard_prior(h, w, ph, pw),
        on_search=lambda name: marks.__setitem__(name, mark()))
    trained = [n for n, label in optimizer.labels.items() if label != "frozen"]
    params = dict(model.named_parameters())
    before = {n: params[n].detach().clone() for n in trained}

    t0 = time.perf_counter()
    _, metrics = step(x, y)
    record["first_loss"] = float(metrics["loss"])
    record["first_step_ms"] = 1e3 * (time.perf_counter() - t0)
    step_ms, search_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, metrics = step(x, y)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        search_ms.append(ms_between(marks["search_start"], marks["search"]))
    record.update(
        step_ms=step_ms, search_ms=search_ms,
        last_loss=float(metrics["loss"]), bpp=float(metrics["bpp"]),
        trained_params=len(trained),
        unmoved_params=[n for n in trained
                        if torch.equal(before[n], params[n])],
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None))
    return Trained(model, ae, x, y)


def run(steps: int = 3, crop=CROP, device="cuda", seed: int = 0,
        row_chunks=ROW_CHUNKS):
    """-> (report, Trained of the attempt that fitted, or None). Each row
    chunk is tried in turn until one fits; only
    `torch.cuda.OutOfMemoryError` moves on to the next."""
    dev = resolve_device(device)
    x_np, y_np = frames(*crop, seed=seed)
    x, y = (torch.from_numpy(a).to(dev) for a in (x_np, y_np))
    report = {"config": "ae_cityscapes_stereo (spatial_shards = 1, "
                        "sifinder_impl = 'tiled') + pc_default",
              "crop": list(crop), "batch": 1, "steps": steps, "seed": seed,
              "device": str(dev), "card": card_name(dev),
              "clock": "cuda_events" if dev.type == "cuda" else "host",
              "attempts": []}
    for row_chunk in row_chunks:
        ae, pc = configs(crop, row_chunk)
        record = {"sifinder_row_chunk": row_chunk,
                  "compute_dtype": str(ae.compute_dtype),
                  "remat": bool(ae.remat)}
        report["attempts"].append(record)
        try:
            trained = _attempt(ae, pc, x, y, steps, dev, seed, record)
        except torch.cuda.OutOfMemoryError as err:
            record.update(ok=False, error=repr(err)[:2000])
            print(f"row chunk {row_chunk}: out of memory", file=sys.stderr,
                  flush=True)
            del err
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            continue
        record["ok"] = True
        report["ok"] = math.isfinite(record["last_loss"])
        return report, trained
    report["ok"] = False
    return report, None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--crop", default=",".join(map(str, CROP)),
                   help="H,W of the frames (tiles 16x32 patches)")
    p.add_argument("--out", default=None, help="also write the report here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    crop = tuple(int(v) for v in args.crop.split(","))
    report, _ = run(args.steps, crop, args.device, args.seed)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
