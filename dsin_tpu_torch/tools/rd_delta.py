"""The precision ladder's rate-distortion gate (counterpart of the JAX
package's `bench.py` `BENCH_RD_DELTA=1`, `run_rd_delta`).

At every rung of the ladder (`coding/precision.py`: fp32, bf16, int8) the
model is built from one set of weights, one deterministic image batch is
encoded and decoded through `serve/device.DeviceServer`, and the
reconstruction is scored with `eval/reporting.psnr_np` and
`eval/msssim_np.multiscale_ssim_np(levels=3)`. Two verdicts:

* the PSNR and MS-SSIM losses of bf16 and int8 against fp32 stay inside
  pinned budgets (bf16 1.0 dB / 0.01, int8 3.0 dB / 0.05, as the JAX gate);
* one symbol volume (the fp32 rung's first image) coded through every
  rung's codec in mode 2 (numpy engine) and mode 3 (the probclass front
  kernel, K3) gives byte-identical streams, each decoding exactly. Any
  divergence is a hard failure, never a budgeted delta: the entropy side is
  float32 at every rung.

The weights are seeded (seed 0, as the JAX gate's); `run_rd_delta(params=)`
takes the JAX package's trees instead (numpy arrays, loaded through
`bridge.py`), so the gate can be held against the JAX gate's weights.

CLI (prints one JSON line with the JAX gate's keys; exits 1 on a
violation):
    python -m dsin_tpu_torch.tools.rd_delta [--ae_config P] [--pc_config P] \
        [--h 48] [--w 96] [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from typing import Optional

import numpy as np

from dsin_tpu_torch.coding import precision as precision_lib
from dsin_tpu_torch.coding.loader import build_at_rung, make_codec
from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.eval.msssim_np import multiscale_ssim_np
from dsin_tpu_torch.eval.reporting import psnr_np
from dsin_tpu_torch.runtime import config_path, resolve_device
from dsin_tpu_torch.serve.device import DeviceServer
from dsin_tpu_torch.train import checkpoint as ckpt_lib

MODES = ("wavefront_np", "wavefront_pl")
#: rung -> (PSNR budget dB, MS-SSIM budget), the JAX gate's defaults
BUDGETS = {"bf16": (1.0, 0.01), "int8": (3.0, 0.05)}


def gate_images(h: int, w: int, batch: int = 2) -> np.ndarray:
    """The JAX gate's structured images: a gradient plus seeded noise
    (`np.random.default_rng(0)`), (batch, h, w, 3) float32 in [0, 255]."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    grad = (yy / h * 160.0 + xx / w * 80.0)[..., None] * np.ones(3)
    return np.clip(grad[None] + rng.normal(0.0, 24.0, size=(batch, h, w, 3)),
                   0, 255).astype(np.float32)


def run_rd_delta(ae_config: str = config_path("ae_synthetic_micro"),
                 pc_config: str = config_path("pc_default"),
                 h: int = 48, w: int = 96, budgets=None, device="cuda",
                 seed: int = 0, params: Optional[tuple] = None) -> dict:
    """The gate's result: per-rung PSNR / MS-SSIM, their deltas against
    fp32, the streams' sha256, the violations and the verdict. `params` is
    an optional (params, batch_stats) pair of the JAX package's trees."""
    budgets = dict(BUDGETS if budgets is None else budgets)
    dev = resolve_device(device)
    ae = parse_config_file(ae_config).replace(AE_only=True)
    pc = parse_config_file(pc_config)
    state = (None if params is None
             else ckpt_lib.ModelState(params[0], params[1]))
    x_host = gate_images(h, w)

    per_rung, fixed_sym, streams = {}, None, {}
    for rung in precision_lib.RUNGS:
        model, _ = build_at_rung(ae, pc, device=dev, seed=seed,
                                 precision=rung, state=state)
        server = DeviceServer.for_model(model)
        sym = server.encode_symbols(x_host)
        x_dec = server.decode(sym).cpu().numpy()
        sym = sym.cpu().numpy()
        codec = make_codec(model)
        if fixed_sym is None:
            # one volume for every rung's codec: the question is the
            # codec's numerics, not the encoder's symbol drift
            fixed_sym = np.ascontiguousarray(
                np.transpose(sym[0], (2, 0, 1)).astype(np.int32))
        rung_streams = {}
        for mode in MODES:
            stream = codec.encode(fixed_sym, mode=mode)
            rung_streams[mode] = hashlib.sha256(stream).hexdigest()
            if not np.array_equal(codec.decode(stream), fixed_sym):
                raise RuntimeError(
                    f"rd-delta: {rung}/{mode} stream failed its round trip")
        streams[rung] = rung_streams
        per_rung[rung] = {
            "psnr": round(psnr_np(x_host, x_dec), 4),
            "msssim": round(multiscale_ssim_np(x_host, x_dec, levels=3), 6),
            "stream_sha256": rung_streams,
        }
        del model, server, codec

    violations = []
    ref = per_rung["fp32"]
    for rung, (psnr_budget, ms_budget) in budgets.items():
        entry = per_rung[rung]
        entry["psnr_delta"] = round(ref["psnr"] - entry["psnr"], 4)
        entry["msssim_delta"] = round(ref["msssim"] - entry["msssim"], 6)
        entry["budgets"] = {"psnr_db": psnr_budget, "msssim": ms_budget}
        if entry["psnr_delta"] > psnr_budget:
            violations.append(f"{rung} PSNR delta {entry['psnr_delta']} dB "
                              f"> budget {psnr_budget}")
        if entry["msssim_delta"] > ms_budget:
            violations.append(f"{rung} MS-SSIM delta "
                              f"{entry['msssim_delta']} > budget {ms_budget}")
    for mode in MODES:
        if len({streams[r][mode] for r in precision_lib.RUNGS}) != 1:
            violations.append(
                f"HARD: probclass stream divergence across rungs in {mode}: "
                f"{ {r: streams[r][mode] for r in streams} }")

    return {
        "metric": "precision_rd_psnr_delta_max",
        "value": round(max(per_rung[r]["psnr_delta"] for r in budgets), 4),
        "unit": "dB",
        "vs_baseline": None,
        "shape": [h, w],
        "per_rung": per_rung,
        "streams_bit_identical": not any(v.startswith("HARD")
                                         for v in violations),
        "violations": violations,
        "pass": not violations,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the precision ladder's RD gate")
    p.add_argument("--ae_config", default=config_path("ae_synthetic_micro"))
    p.add_argument("--pc_config", default=config_path("pc_default"))
    p.add_argument("--h", type=int, default=48)
    p.add_argument("--w", type=int, default=96)
    for rung, (psnr_b, ms_b) in BUDGETS.items():
        p.add_argument(f"--psnr_budget_{rung}", type=float, default=psnr_b)
        p.add_argument(f"--msssim_budget_{rung}", type=float, default=ms_b)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    budgets = {rung: (getattr(args, f"psnr_budget_{rung}"),
                      getattr(args, f"msssim_budget_{rung}"))
               for rung in BUDGETS}
    result = run_rd_delta(args.ae_config, args.pc_config, args.h, args.w,
                          budgets=budgets, device=args.device)
    print(json.dumps(result), flush=True)
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
