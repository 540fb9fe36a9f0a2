"""Rate-distortion sweep: train and evaluate one model per target bitrate
(counterpart of the JAX package's `eval/rd_sweep.py`).

For each target bpp it derives `H_target = bpp * 64 / num_chan_bn` (the
inverse of `bpp = H_target / (64 / C)`), runs `main.run` (train, then test
the best-val checkpoint) and collects each point's test means into
`<out_root>/rd_curve.json`, rewritten after every point so a late crash
keeps the finished ones.

CLI:
    python -m dsin_tpu_torch.eval.rd_sweep -ae_config <path> \
        [--targets 0.02 0.08] [--max_steps N] [--max_test_images N] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

from dsin_tpu_torch.config import Config, parse_config_file
from dsin_tpu_torch.runtime import config_path
from dsin_tpu_torch.utils.logging import color_print

DEFAULT_TARGETS = (0.01, 0.02, 0.04, 0.08)


def h_target_for_bpp(bpp: float, num_chan_bn: int) -> float:
    """The rate target of a bpp: the inverse of bpp = H_target / (64 / C)."""
    return bpp * 64.0 / num_chan_bn


def sweep(ae_config: Config, pc_config: Config, out_root: str = ".",
          targets: Sequence[float] = DEFAULT_TARGETS,
          max_steps: Optional[int] = None,
          max_val_batches: Optional[int] = None,
          max_test_images: Optional[int] = None,
          device="cuda", seed: int = 0) -> List[Dict[str, float]]:
    """Run the pipeline once per target bpp on `device` (the card by
    default); returns one result dict per point and writes
    `<out_root>/rd_curve.json`."""
    from dsin_tpu_torch.main import run

    out_path = os.path.join(out_root, "rd_curve.json")
    os.makedirs(out_root or ".", exist_ok=True)
    points = []
    for bpp in targets:
        h_t = h_target_for_bpp(bpp, ae_config.num_chan_bn)
        color_print(f"RD point: target_bpp={bpp} (H_target={h_t})", "cyan",
                    bold=True)
        results = run(ae_config.replace(H_target=h_t), pc_config,
                      out_root=out_root, max_steps=max_steps,
                      max_val_batches=max_val_batches,
                      max_test_images=max_test_images, device=device,
                      seed=seed)
        points.append({"target_bpp": bpp, "H_target": h_t, **results})
        with open(out_path, "w") as f:
            json.dump(points, f, indent=2)

    color_print(f"RD curve written to {out_path}", "green", bold=True)
    return points


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="dsin_tpu_torch RD sweep")
    p.add_argument("-ae_config", default=config_path("ae_kitti_stereo"))
    p.add_argument("-pc_config", default=config_path("pc_default"))
    p.add_argument("--out_root", default=".")
    p.add_argument("--targets", type=float, nargs="+",
                   default=list(DEFAULT_TARGETS))
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--max_test_images", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    sweep(parse_config_file(args.ae_config), parse_config_file(args.pc_config),
          out_root=args.out_root, targets=args.targets,
          max_steps=args.max_steps, max_test_images=args.max_test_images,
          device=args.device)


if __name__ == "__main__":
    main()
