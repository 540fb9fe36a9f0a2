"""Time the fused decode epilogue kernel (K4) on the card, warm and cold, for
one or more versions of its source, in turns.

    python -m dsin_tpu_torch.tools.k4_bench [--source A.cu --source B.cu]
        [--turns 1] [--seed 0] [--out F.json]

Each `--source` (default: the package's `csrc/decode_epilogue.cu`) is a
version of the kernel with the same `extern "C"` entry; it is built with the
module's flags and run through `ops/epilogue.launch`. The operands are the
main path's: the conv2 of the full-width decoder (ae_kitti_stereo, seeded
weights) folded by `fold_epilogue_params`, and N(0, 1) activations of
(2, 160, 612, 64), in float32 and in bfloat16. Each version's output is held
against the plain version (rtol 1e-5, atol 1e-3). Versions run in turns:
A B .. B A, `turns` times over.

Times are CUDA events:
  * warm: back-to-back launches on the same input, enqueued while the device
    slept, so the input sits in the 50 MB L2 (the float32 input is 25 MB);
  * cold: before each launch a 128 MiB buffer is written, which evicts L2;
    the same writes are timed alone and subtracted, so the time is the
    kernel's with its input in device memory, as a caller that just ran the
    decoder would find it.
Prints one line per (version, dtype) and, last, a JSON object; exits 1 when
a version disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from dsin_tpu_torch.entry import full_configs
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops import epilogue as ek
from dsin_tpu_torch.runtime import resolve_device

SHAPE = (2, 160, 612, 64)
RTOL, ATOL = 1e-5, 1e-3
FLUSH_BYTES = 128 << 20     # > 2 x the 50 MB L2
WARM_REPS, COLD_REPS = 50, 20


def warm_ms(fn, reps: int = WARM_REPS) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up. The
    device first sleeps about 10 ms, so the host enqueues the runs ahead of
    it: a short kernel is timed back to back on the device, not at the
    host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cold_ms(fn, reps: int = COLD_REPS, flush_bytes: int = FLUSH_BYTES):
    """(mean device ms of fn() with L2 flushed before each run, ms of one
    flush). A `flush_bytes` buffer is written before every run; the writes
    alone are timed the same way and subtracted."""
    buf = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")

    def timed(with_fn: bool) -> float:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for i in range(reps):
            buf.fill_(float(i))
            if with_fn:
                fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    fn()
    timed(False)
    flush = timed(False)
    both = timed(True)
    return both - flush, flush


def operands(seed: int, dev):
    """{dtype name: (x, wmat, img_scale, img_bias, st_mat, st_bias)}."""
    ae, pc = full_configs()
    model = build_model(ae, pc, device=dev, seed=seed)
    epi = ek.fold_epilogue_params(model.decoder, ae.normalization)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        SHAPE).astype(np.float32)).to(dev)
    return {str(dt).replace("torch.", ""): (x.to(dt), epi.wmat.to(dt))
            + tuple(epi[1:]) for dt in ek.DTYPES}


def ptxas_summary(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", action="append", type=Path)
    parser.add_argument("--turns", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    sources = args.source or [ek.SOURCE]
    libs = [ek.load_library(s.resolve()) for s in sources]
    for src, lib in zip(sources, libs):
        print(f"{src}: ptxas {ptxas_summary(lib.ptxas_log)}", flush=True)
    ops = operands(args.seed, dev)
    ref = {name: ek.epilogue_reference(*o) for name, o in ops.items()}
    order = list(range(len(libs)))
    order = (order + order[::-1]) * args.turns
    runs, bad = [], 0
    for v in order:
        for name, o in ops.items():
            got = ek.launch(libs[v], *o)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max())
                      for g, r in zip(got, ref[name]))
            ok = all(torch.allclose(g, r, rtol=RTOL, atol=ATOL)
                     for g, r in zip(got, ref[name]))
            bad += not ok
            warm = warm_ms(lambda: ek.launch(libs[v], *o))
            cold, flush = cold_ms(lambda: ek.launch(libs[v], *o))
            runs.append(dict(source=str(sources[v]), dtype=name, warm_ms=warm,
                             cold_ms=cold, flush_ms=flush, max_abs_err=err,
                             agrees=ok))
            print(f"{sources[v]} {name}: warm {warm:.4f} ms, cold {cold:.4f}"
                  f" ms (flush {flush:.4f} ms subtracted), max |kernel - "
                  f"plain| {err:.3g}{'' if ok else ' DISAGREES'}", flush=True)
    result = dict(card=card, shape=SHAPE, runs=runs,
                  ptxas={str(s): ptxas_summary(lib.ptxas_log)
                         for s, lib in zip(sources, libs)})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
