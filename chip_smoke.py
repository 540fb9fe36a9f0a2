"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases; any failure raises, prints no result and exits non-zero:
  1. card check: needs torch.cuda; prints the card's name and power limit;
  2. build: builds csrc/sifinder_argmax.cu, csrc/probclass_front.cu and
     csrc/decode_epilogue.cu with nvcc and csrc/range_coder.cpp with g++,
     all four at once, and prints the build times, ptxas's register /
     spill lines and the tensor-core instructions in the search kernel's
     SASS (`cuobjdump -sass`: HMMA.1688.F32.TF32, none is a failure);
  3. kernel vs plain at 320x1224 with 20x24 patches: pearson_argmax at batch 2
     (random inputs with the Gaussian prior, and planted patches without it)
     and pearson_argmax_shared at batch 4, each against its plain torch
     version; prints times (CUDA events), two bounds (the fp32 products on
     the CUDA cores and, the least time, the same products as 3xTF32 on the
     tensor cores, which the kernel runs) with the kernel's share of each,
     and a yardstick library call (materialized F.conv2d score map +
     argmax, never called by the port); then sifinder_dtype='bfloat16'
     once through the kernel route: K1 on the bfloat16-rounded operands
     against its plain version, and the route's y_syn equal to what K1
     gives there;
  4. the slice at the full width of ae_kitti_stereo + pc_default with seeded
     weights: one session, 4 requests (encode -> decode_si) and one
     from-scratch forward at batch 2, each checked for shape, finite values
     and range, and for launches of its kernel, then timed stage by stage
     (CUDA events), and the decoder with cudnn.deterministic on and off;
     then the tiny configuration through the kernel on the
     card against the plain search on the CPU;
  5. the codec at full width: probclass_front_logits (K3) against its plain
     version at B = 1, 5, 64, 128, 256 and the largest front (248) on blocks
     drawn from the centers with the full-width pc_default weights (within
     1e-5, rows bit-identical across B and under a permutation, and
     unchanged by NaN in every input no logit needs), timed at the largest
     front beside its bound (the work the logit needs) and a cuDNN
     yardstick; then the symbols of 2 images from DeviceServer.encode coded
     in mode 3 (K3) and mode 2 (numpy engine), each decoded exactly, with
     one K3 launch per front; K3 timed at each bucket of a pass beside its
     bound, and its device time per pass;
     decode_si on the decoded symbols bit-equal to decode_si on the
     originals; compress_array -> decompress_array with and without a side
     image;
  6. the precision ladder: fused_decode_epilogue (K4) against its plain
     version at (2, 160, 612, 64), the full-width decoder's own activation
     before its last deconv, folded from its conv2, with float32 and bfloat16
     operands (rtol 1e-5, atol 1e-3 in pixel units for both: bfloat16
     operands are widened to float32, their products are exact there, so both
     sum the same float32 products in another order), rows bit-identical
     across the batch, the float32 image equal to the decoder's own output
     within the same bound; timed warm (back to back) and cold (a 128 MiB
     write before each launch, timed alone and subtracted) beside its bound,
     ptxas's registers and spill, and the library chain
     (F.conv_transpose2d + crop, affine, clip, 3x3 map); then the serve-bench
     precision leg at 320x1224, batch 2, fp32, bf16 and int8, which must pass
     gate_precision (every stage timed, no build in the timed window, mode-2
     and mode-3 streams byte-identical across the rungs and exact round
     trips) and launch K2, K3 and K4; at the default seed, every rung's
     streams must keep the pinned sha256 prefixes (STREAM_PINS);
  7. the test run at full width: a synthetic stereo test split of 4 pairs at
     375x1242 (`data/synthetic.py`, PNGs by `data/png.py`) with its
     KITTI-format manifest in a temporary directory; the seeded model saved
     by `train/checkpoint.save_checkpoint` (AE and siNet partitions, the
     pc-config hash and seed in the manifest), restored bit-equal into
     another model with the manifest verified, and a copy with one byte of
     `params_decoder.msgpack`'s array data flipped refused with
     ManifestMismatch; then `dsin_tpu_torch.main.run` in test mode
     (load_model, real_bpp, mode 3) at the 320x1224 eval crop, with K1 and K3
     launch counts read around it. Each image's x_with_si and bpp must equal
     `entry.make_forward` on the same crop and weights bit for bit (the same
     modules and the same K1 factors; both hold the prior as its factors),
     its real bpp must be its mode-3 stream's, which
     decodes exactly, with a coding gap >= -32 bits - 0.02% of the ideal
     bits (GAP_FLOOR_SHARE), and every score list and PNG must be written,
     the PNGs reading back bit-equal; prints the per-image stage times, the
     save, restore and prior-check times;
  8. training at full width, batch 1 at the 320x960 training crop: K1
     against its plain version at that shape with the Gaussian prior, timed
     beside its bound; one train step of ae_kitti_stereo + pc_default from
     seeded weights on a crop of a synthetic KITTI-sized pair, which must
     launch K1 once, give finite metrics, move every trained parameter and
     every running statistic (and no statistic under bn_stats = 'frozen');
     the same step with the search's plain version on the card (indices
     equal beyond the 1e-4 margin; where all are equal, y_syn, the loss,
     the gradients and the new state bit-equal); the same step twice from
     one state, and a save / restore with opt_state.msgpack between two
     steps, both bit-equal; then `dsin_tpu_torch.main.run` training 6 steps
     on a synthetic split of 375x1242 pairs, validating and saving a
     periodic checkpoint every 4 steps, testing the best-val checkpoint
     with real bpp, and a second run resuming it (numbering, best_val) for
     2 more: K1 once per step, validation batch and test image, K3 once per
     front. The first run has a profile_dir and a replicate_to: its trace
     must hold exactly the 3 train_step annotations of its window (steps
     3-5), K1 launched once inside each and once per validation batch
     processed in the window, and device events; it prints the 10 kernels
     with the most device time and the operator (with its input shapes)
     that launched each; the replica of its best-val checkpoint must match
     its manifest's CRCs and carry the source's params_digest, and a second
     (forced) best-val save must rotate the replica's .prev-*; last the ms
     per train step (median of 5 warm steps, host clock)
     split by CUDA events into forward, backward and optimizer, the peak
     memory, and the same at compute_dtype = 'bfloat16';
  9. the rest of the patch search and the Cityscapes geometry: (a) the
     tiled search at 320x1224, batch 2, standard prior as factors, row chunk
     32, held against K1 (winning scores within 1e-5, indices equal beyond
     the 1e-4 margin) and against the materialized torch route (indices
     equal; where the winning scores are not bit-equal, beyond the margin),
     timed with its peak memory beside that route's; (b) a custom prior
     (the Gaussian x 0.5 + 0.25) under 'auto' must take the tiled route
     (route counts read, no kernel launch) and match the materialized
     route; (c) DeviceServer.decode_si with_scores, 4 requests on one
     session, on 'auto' (the torch route), 'torch' and 'tiled': images
     bit-equal with the flag on and off on one route, scores within 1e-5 of
     K2's best values; (d) use_L2andLAB at the full width of
     ae_kitti_stereo, 320x1224: one entry.make_forward at batch 2 and a
     session of 4 requests, finite, in range, no K1/K2 launch, timed with
     their peak memory, and 40 planted patches found exactly; (e)
     tools/cityscapes_chip.run: ae_cityscapes_stereo at 1024x2048, batch 1,
     bf16, remat, the tiled search, one warm-up and 3 timed train steps
     (finite loss, every trained parameter moved; ms per step, the search's
     ms inside each step, the row chunk that fitted, the peak memory), then
     K1 on one decoded pair of that geometry (P = 4096, 16x32 patches)
     against the tiled search beyond the 1e-4 margin, timed beside its
     bound and its plain version;
 10. the compression service at full width: `serve.CompressionService`
     with ae_kitti_stereo + pc_default from `--seed`, buckets 160x600 and
     320x1224, batches of 4, max_wait_ms 5, 4 entropy threads, pipeline
     depth 2, enable_si, metrics on an ephemeral port; start + warmup, then
     the native build count; 2 sessions on smooth stereo-like side images;
     4 client threads encode 16 images (10 at 320x1224, 2 at 300x1200, 4
     at 150x590), then decode_si every large-bucket stream against its
     session and decode the others. Checks: every DSRV frame parses, every
     payload byte-equal to BottleneckCodec.encode_batch of DeviceServer's
     symbols for the batch the service formed (its batch hook records
     them) and decoding to exactly those symbols; every image bit-equal to
     DeviceServer on the recorded batch, cropped and cast the same way; K2
     launched once per SI batch, K1 never; K2 against its plain version on
     one recorded SI batch's operands (the 1e-4 margin rule); no native
     build after warmup; a flipped byte refused at the door, a payload
     corrupted in the worker failing only its own future (IntegrityError),
     an unknown session raising SessionExpired; /healthz and /metrics
     answering; drain() True with every future resolved. Prints whether an
     image is bit-equal alone and inside a full batch (not a gate), the
     open_session ms, submit -> result ms per kind (median, max), the
     per-kind serve_device_ms / serve_entropy_ms histograms, the overlap
     ratio, requests per second and the peak device memory (run A, the
     thread backend). Then the same traffic (same seed, images and side images)
     on the process entropy backend, 4 children: C, shm at depth 4 (PR
     12's runs B, pipe at depth 2, C, shm at depth 2 with the SIGKILL, and
     D, shm at depth 4, became this one run in PR 15 to make room for
     phase 13; phases 11 and 13 (a) run the pipe at depth 2). Run C holds
     every encode stream byte-equal and every decoded image bit-equal to run
     A's, K2 once per SI batch, no native build after warmup in the parent or
     any child (the children's pings, before and after the traffic), no CUDA
     context and no module the parent does not hold in a child, lane sends on
     shm, no pool rebuild, drain() True with every future resolved; on C, after
     the traffic, one child is SIGKILLed and the next encode must rebuild the
     pool once and give run A's bytes. Each run prints the same numbers as run
     A, its warmup s (child spawn included, with when each child's initializer
     started and the size of the pool's start-up arguments), its shm lane sends
     and fallbacks and the host's cores;
 11. the model lifecycle at full width (the phase 10 service on the process
     backend, pipe, 4 children a bundle, quality on, the canary prober every
     second, the watchdog armed), from two checkpoints A and B saved from
     seeds with their manifests, the service started on A: (1) the publish
     flow for B (prepare_swap -> canary_goldens(staged=True) -> abort_swap ->
     re-save as B' with the goldens), the abort leaving no child and no
     dsintorch segment behind; (2) phase 10's traffic mix from 4 clients
     while prepare_swap(B') + commit_swap land mid-stream: no request fails
     (a session opened before the commit answers SessionExpired and is
     re-opened), every encode stream is byte-equal to A's or B''s stream of
     that image alone, and only B''s after the commit; K2's launches equal
     the SI micro-batches that ran plus the staged bundle's warm and canary
     probe (scores off on the card: K2 runs with quality on); (3) rollback()
     to A's digest and streams; (4) B'' (B' bit-flipped, B''s goldens)
     refused with CanaryFailed, nothing staged; (5) swap_model(B'',
     canary=False): the prober catches it and the watchdog rolls back to A
     by itself; (6) a kill in the prepare window (serve.swap) and (7) a
     corrupted manifest (ckpt.manifest) refused typed, A serving; no native
     build after warmup; after the drain no child and no segment. Prints the
     prepare s split into load, warm and pool start, commit ms (with no
     bundle displaced, and with B' displaced in (5)), rollback ms,
     the canary probe ms per bucket, the seconds from the forced commit to
     the watchdog's rollback and requests/s before, during and after the
     prepare window, each beside the card's name and power limit;
 12. the rate-distortion path at the full width of ae_kitti_stereo +
     pc_default: (a) the 3-phase run of `eval/synthetic_rd.py` through its
     CLI's configuration (a corpus of 40 / 8 / 8 synthetic pairs at the
     320x1224 eval crop generated in a temporary directory, the config's
     KITTI manifests rewired to it), 12 steps a phase, 2 test images: both
     points finite; each with-SI test image's real bpp its mode-3 stream's,
     which decodes exactly; the phase-2 warm start holding phase 1's scored
     AE partitions bit-equal and siNet at its seeded init, at step 0; K1
     launched once per phase-2 step, phase-2 validation batch and SI test
     image, K3 once per front of each real-bpp encode and of each decode
     that checks it. Then the same command again: phase 1 skipped by its
     marker, phase 2 resumed for exactly 1 step. (b) `eval/rd_sweep.sweep`
     at targets 0.02 and 0.08, 2 steps and 1 test image a point:
     rd_curve.json holds both points with H_target = bpp * 64 / 32, K1
     once per step, validation batch and test image. (c) the precision
     RD-delta gate (`tools/rd_delta.py`) at its default (ae_synthetic_micro,
     48x96) and at ae_kitti_stereo on 160x600 images: pass, streams
     byte-identical across the rungs in both modes, K3 launched once per
     front of each mode-3 encode and decode at every rung. Prints both RD
     points (bpp, PSNR, MS-SSIM, real bpp), ms per step per phase, test ms
     per image and the gates' deltas;
 13. the front door at full width (phase 10's buckets, batches of 4, one
     worker, every service on phase 11's checkpoint A): (a) one service on
     the process backend (pipe, depth 2) with
     default_priority_classes(8) and the admission gate; 4 unloaded
     interactive encodes at 320x1224 set the SLO at 3x their median, then
     64 encodes open loop at 6/s, interactive 1 in 8, over phase 10's
     images must shed bulk first and only bulk, complete interactive
     within the SLO at p99 (however many cores the host's probe reads),
     leave no untyped or hung future and build nothing (the serve bench's
     front-door gate); it then records the
     references below. (b) the FrontDoorRouter at 1 and 2 spawned replicas
     sharing the card (thread backend, 4 entropy threads, pipe), 36
     encodes at 3/s: every replica's probe streams equal each other's, the
     1-replica run's and the in-process service's, no build after a ready
     handshake; requests/s, scaling_vs_1 (the 1.3 floor printed, not
     gated), routing, each replica's start. (d) on the 2-replica fleet
     after its traffic (not a fresh one, to keep the script under 800 s):
     swap_model(B) gives B's digest and equal streams on both,
     rollback() A's streams; prepare s and commit round-trip ms per
     replica. (c) then, on the same fleet: 2 sessions pinned to replicas 0
     and 1, decode_si bit-equal to the in-process service's (K2 in each
     child); replica 1 SIGKILLed with decode_si and an encode in flight:
     typed SessionExpired, the encode rerouted and answered, replica 0's
     session serving, a new session opened, serve_router_session_orphans
     >= 1, 1 live replica. K2's launches, read from each replica's
     registry, equal its SI micro-batches + its warmup's 2 (+ 2 in a
     prepare).
Each phase's wall time is printed after the last phase.
Kernel times are CUDA events around back-to-back runs that the host
enqueued while the device slept, so they are device time.
Then one line with the card, one JSON line with the kernels, and last the
result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from dsin_tpu_torch.coding import cli as cli_lib
from dsin_tpu_torch.coding import codec as codec_lib
from dsin_tpu_torch.coding import precision as precision_lib
from dsin_tpu_torch.coding import probclass_kernel as pk
from dsin_tpu_torch.coding import rans
from dsin_tpu_torch import main as main_lib
from dsin_tpu_torch import native_build
from dsin_tpu_torch.coding.loader import make_codec, restore_checkpoint
from dsin_tpu_torch.data import png
from dsin_tpu_torch.data import synthetic
from dsin_tpu_torch.data.loader import random_pair_crops
from dsin_tpu_torch.data.manifest import read_pair_manifest
from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.entry import entry, full_configs, make_forward
from dsin_tpu_torch.eval import rd_sweep, synthetic_rd
from dsin_tpu_torch.eval.reporting import ScoreLists
from dsin_tpu_torch.models import probclass as pc_lib
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.models.quantizer import centers_lookup
from dsin_tpu_torch.ops import color as color_lib
from dsin_tpu_torch.ops import epilogue as ek
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.ops import sifinder_kernel as sk
from dsin_tpu_torch.ops.patches import assemble_patches
from dsin_tpu_torch.runtime import config_path, resolve_device
from dsin_tpu_torch.serve.device import DeviceServer
from dsin_tpu_torch.tools import cityscapes_chip
from dsin_tpu_torch.tools import k1_bench
from dsin_tpu_torch.tools import k4_bench
from dsin_tpu_torch.tools.k4_bench import warm_ms as cuda_ms
from dsin_tpu_torch.tools import serve_bench as leg_lib
from dsin_tpu_torch.train import checkpoint as ckpt_lib
from dsin_tpu_torch.train import optim as optim_lib
from dsin_tpu_torch.train import step as step_lib
from dsin_tpu_torch.tools import rd_delta
from dsin_tpu_torch.utils import profiling
from dsin_tpu_torch.utils.logging import JsonlLogger

H, W, PH, PW = 320, 1224, 20, 24
FP32_PEAK = k1_bench.FP32_PEAK   # H100 SXM fp32 outside the tensor cores
BF16_PEAK = 989e12         # H100 SXM bf16 dense (tensor cores), 700 W
HBM_RATE = k1_bench.HBM_RATE     # H100 SXM device memory, bytes/s
VAL_RTOL, VAL_ATOL = 1e-4, 1e-5   # fp32 sums in another order
MARGIN_ATOL = 1e-4         # indices equal where the top-two margin exceeds it
K3_RTOL, K3_ATOL = 1e-5, 1e-5     # as tests/test_probclass_pallas.py:49
K3_BATCHES = (1, 5, 64, 128, 256)   # and the largest front of the volume
K4_RTOL, K4_ATOL = 1e-5, 1e-3     # as tests/test_epilogue_pallas.py:32
LEG_REPS = 5
# sha256 prefixes of the precision leg's streams at the default seed, every
# rung: what the dense probclass front kernel gave; the pruned one must give
# the same logits bit for bit, hence the same streams
STREAM_PINS = {"wavefront_np": "54aab8cb7a425f84",
               "wavefront_pl": "cff25dce13d128d5"}
SOURCES = {
    "pearson_argmax": "dsin_tpu_torch/csrc/sifinder_argmax.cu",
    "pearson_argmax_shared": "dsin_tpu_torch/csrc/sifinder_argmax.cu",
    "probclass_front_logits": "dsin_tpu_torch/csrc/probclass_front.cu",
    "fused_decode_epilogue": "dsin_tpu_torch/csrc/decode_epilogue.cu",
}
REPLACES = {
    "pearson_argmax": "dsin_tpu/ops/sifinder_pallas.py:146",
    "pearson_argmax_shared": "dsin_tpu/ops/sifinder_pallas.py:340",
    "probclass_front_logits": "dsin_tpu/coding/probclass_pallas.py:115",
    "fused_decode_epilogue": "dsin_tpu/ops/epilogue_pallas.py:167",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def stage_ms(steps) -> str:
    """Device-timeline ms of each (name, fn) step, run in order after one
    warm-up pass, with CUDA events recorded between the steps."""
    with torch.inference_mode():
        for _, fn in steps:
            fn()
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(steps) + 1)]
        events[0].record()
        for i, (_, fn) in enumerate(steps):
            fn()
            events[i + 1].record()
        torch.cuda.synchronize()
    return ", ".join(f"{name} {events[i].elapsed_time(events[i + 1]):.2f}"
                     for i, (name, _) in enumerate(steps))


def smooth_images(rng, n: int, extra_w: int = 0) -> np.ndarray:
    """Seeded smooth RGB images in [0, 255] (bilinear-upsampled noise)."""
    base = rng.uniform(0, 255, (n, 3, H // 8, (W + extra_w) // 8))
    up = F.interpolate(torch.from_numpy(base).float(), size=(H, W + extra_w),
                       mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous().numpy()


def operands(x, y, prior: bool, dev):
    """Kernel operands (y_t, pk, inv_denom, gh, gw_t) from NHWC images
    (numpy arrays or tensors), through the port's own preps."""
    x, y = (torch.as_tensor(t).to(dev) for t in (x, y))
    h, w = x.shape[1:3]
    pk = sk.prepare_query(x, PH, PW)
    sides = [sk.side_from_transformed(color_lib.search_transform(yi), PH, PW)
             for yi in y]
    if prior:
        gh, gw = sifinder_lib.gaussian_position_mask_factors(h, w, PH, PW)
    else:
        p = (h // PH) * (w // PW)
        gh = np.ones((h - PH + 1, p), np.float32)
        gw = np.ones((w - PW + 1, p), np.float32)
    return (torch.stack([s[0] for s in sides]),
            pk, torch.stack([s[1] for s in sides]),
            torch.from_numpy(gh).to(dev),
            torch.from_numpy(np.ascontiguousarray(gw.T)).to(dev))


def check_agreement(name, ops, got, ref, planted=None):
    val, idx = got
    rval, ridx = ref
    torch.testing.assert_close(val, rval, rtol=VAL_RTOL, atol=VAL_ATOL)
    bad = int(sk.index_disagreements(ops, PH, PW, idx, rval, ridx,
                                     MARGIN_ATOL).sum())
    equal = int((idx == ridx).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} index disagreements beyond the "
                             f"{MARGIN_ATOL} margin")
    if planted is not None:
        for b, p, flat in planted:
            if int(idx[b, p]) != flat or int(ridx[b, p]) != flat:
                raise AssertionError(
                    f"{name}: planted patch {p} of image {b} at {flat}, "
                    f"kernel {int(idx[b, p])}, plain {int(ridx[b, p])}")
    err = float((val - rval).abs().max())
    log(f"  {name}: indices equal {equal}/{idx.numel()} (rest are near-ties "
        f"within {MARGIN_ATOL}), max |val - plain| {err:.3g}"
        + (f", {len(planted)} planted exact" if planted else ""))
    return err


def bound(ops, shared: bool):
    """(bound_ms, bound_by, text) of one K1/K2 call: the least time is the
    3xTF32 one (three TF32 tensor-core products per fp32 product, at 495
    TFLOP/s) or the bytes (inputs read once, outputs written once); `text`
    also names the fp32 CUDA-core bound (67 TFLOP/s)."""
    b = k1_bench.bounds(ops, shared)
    by = "operations" if b["tf32x3_ms"] >= b["bytes_ms"] else "bytes"
    return max(b["tf32x3_ms"], b["bytes_ms"]), by, b


def bound_text(b: dict, ms: float) -> str:
    tf32, fp32 = b["tf32x3_ms"], b["fp32_ms"]
    return (f"bounds 3xTF32 {tf32:.3f} ms ({100 * tf32 / ms:.1f}% of it), "
            f"fp32 {fp32:.3f} ms ({100 * fp32 / ms:.1f}% of it)")


def knob_phase(x: np.ndarray, y: np.ndarray, dev):
    """`sifinder_dtype = 'bfloat16'` through the kernel route once: y_syn
    from `synthesize_side_image` must be what K1 gives on the bfloat16-
    rounded operands, and K1 on them must agree with the plain version on
    the same operands under the margin rule."""
    ae, _ = full_configs()
    cfg = ae.replace(sifinder_impl="kernel", sifinder_dtype="bfloat16")
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    sk.reset_launch_counts()
    y_syn = sifinder_lib.synthesize_side_image(xt, yt, yt, None, PH, PW, cfg)
    if sk.launch_counts["pearson_argmax"] != 1:
        raise AssertionError(f"the bf16 knob's route: {sk.launch_counts}")
    y_t, pk, inv, gh, gw_t = operands(x, y, False, dev)
    ops = (sifinder_lib.round_operand(y_t, torch.bfloat16),
           sifinder_lib.round_operand(pk, torch.bfloat16), inv, gh, gw_t)
    got = sk.pearson_argmax(*ops, PH, PW)
    check_agreement("pearson_argmax bf16-rounded operands b=2", ops, got,
                    sk.pearson_argmax_reference(*ops, PH, PW))
    wc = W - PW + 1
    want = torch.stack([assemble_patches(sifinder_lib.gather_patches(
        yt[i], torch.div(idx, wc, rounding_mode="floor"), idx % wc, PH, PW),
        H, W) for i, idx in enumerate(got[1])])
    if not torch.equal(y_syn, want):
        raise AssertionError("the bf16 knob's route differs from K1 on the "
                             "rounded operands")
    log("  sifinder_dtype='bfloat16' through the kernel route: y_syn equal "
        "to K1's on the rounded operands")


def kernel_phase(seed: int, dev):
    rng = np.random.default_rng(seed)
    rows = {}

    # K1 at batch 2: random images with the prior
    x = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    ops = operands(x, y, True, dev)
    got = sk.pearson_argmax(*ops, PH, PW)
    ref = sk.pearson_argmax_reference(*ops, PH, PW)
    err = check_agreement("pearson_argmax random+prior b=2", ops, got, ref)

    # K1 planted: exact copies of 40 x patches per image, no prior
    xp = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    yp = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    hc, wc, gw_n = H - PH + 1, W - PW + 1, W // PW
    planted = []
    for b in range(2):
        for j, p in enumerate(rng.choice((H // PH) * gw_n, 40, replace=False)):
            r0, c0 = (j // 8) * (PH + 8) + 3, (j % 8) * (PW + 120) + 5
            pr, pc = (p // gw_n) * PH, (p % gw_n) * PW
            yp[b, r0:r0 + PH, c0:c0 + PW] = xp[b, pr:pr + PH, pc:pc + PW]
            planted.append((b, int(p), r0 * wc + c0))
    ops_p = operands(xp, yp, False, dev)
    err = max(err, check_agreement(
        "pearson_argmax planted b=2", ops_p, sk.pearson_argmax(*ops_p, PH, PW),
        sk.pearson_argmax_reference(*ops_p, PH, PW), planted))

    knob_phase(x, y, dev)

    reps = 5
    ms = cuda_ms(lambda: sk.pearson_argmax(*ops, PH, PW), reps)
    plain_ms = cuda_ms(lambda: sk.pearson_argmax_reference(*ops, PH, PW), 2)
    lib_ms = cuda_ms(lambda: k1_bench.library_argmax(ops, PH, PW, False), 2)
    b_ms, b_by, bnds = bound(ops, False)
    rows["pearson_argmax"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  library_ms=lib_ms)
    texts = {"pearson_argmax": bound_text(bnds, ms)}

    # K2 at batch 4: one shared side image, smooth stereo-like pair
    imgs = smooth_images(rng, 1, extra_w=64)
    y1 = imgs[:, :, 16:16 + W]
    x4 = np.clip(np.repeat(imgs[:, :, :W], 4, 0)
                 + rng.normal(0, 4, (4, H, W, 3)), 0, 255).astype(np.float32)
    ops4 = operands(x4, np.repeat(y1, 4, 0), True, dev)
    shared = (ops4[0][0].contiguous(), ops4[1], ops4[2][0].contiguous(),
              ops4[3], ops4[4])
    got = sk.pearson_argmax_shared(*shared, PH, PW)
    ref = sk.pearson_argmax_reference(*ops4, PH, PW)
    err4 = check_agreement("pearson_argmax_shared stereo b=4", ops4, got, ref)
    ms4 = cuda_ms(lambda: sk.pearson_argmax_shared(*shared, PH, PW), reps)
    plain4 = cuda_ms(lambda: sk.pearson_argmax_reference(*ops4, PH, PW), 2)
    lib4 = cuda_ms(lambda: k1_bench.library_argmax(shared, PH, PW, True), 2)
    b4, b4_by, bnds4 = bound(shared, True)
    rows["pearson_argmax_shared"] = dict(max_abs_err=err4, ms=ms4,
                                         plain_ms=plain4, bound_ms=b4,
                                         bound_by=b4_by, library_ms=lib4)
    texts["pearson_argmax_shared"] = bound_text(bnds4, ms4)
    for name, r in rows.items():
        log(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
            f"ms, library {r['library_ms']:.3f} ms, {texts[name]}; bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
    return rows


def check_image(name, img, shape, clipped: bool):
    if tuple(img.shape) != shape:
        raise AssertionError(f"{name}: shape {tuple(img.shape)} != {shape}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{name}: non-finite values")
    if clipped and not (float(img.min()) >= 0.0 and float(img.max()) <= 255.0):
        raise AssertionError(f"{name}: values outside [0, 255]")


def slice_phase(seed: int, dev):
    rng = np.random.default_rng(seed + 1)
    ae, pc = full_configs()
    server = DeviceServer(ae, pc, device=dev, seed=seed)
    imgs = smooth_images(rng, 4, extra_w=64)
    x = np.clip(imgs[:, :, :W] + rng.normal(0, 4, (4, H, W, 3)),
                0, 255).astype(np.float32)
    y = imgs[0, :, 16:16 + W].copy()

    def serve():
        t0 = time.perf_counter()
        prep = server.open_session(y)
        torch.cuda.synchronize()
        log(f"  open_session {1e3 * (time.perf_counter() - t0):.2f} ms")
        t0 = time.perf_counter()
        symbols, bpp = server.encode(x)
        out = server.decode_si(symbols, prep)
        torch.cuda.synchronize()
        return symbols, bpp, out, time.perf_counter() - t0

    serve()                                   # warm-up: cuDNN plans, build
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    symbols, bpp, out, secs = serve()
    launches = dict(sk.launch_counts)
    if launches["pearson_argmax_shared"] < 1:
        raise AssertionError(f"decode_si did not launch the kernel: "
                             f"{launches}")
    check_image("decode_si", out, (4, H, W, 3), clipped=True)
    if tuple(symbols.shape) != (4, H // 8, W // 8, ae.num_chan_bn):
        raise AssertionError(f"symbols shape {tuple(symbols.shape)}")
    if not bool(torch.isfinite(bpp).all()):
        raise AssertionError("bpp estimate not finite")
    log(f"  serve: 4 requests (encode -> decode_si) {1e3 * secs / 4:.2f} ms "
        f"per request, bpp estimate {bpp.mean().item():.4f}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}")
    model, st = server.model, {}
    xt = torch.from_numpy(x).to(dev)
    prep = server.open_session(y)
    log("  serve stages, batch of 4, device ms: " + stage_ms([
        ("encoder+quantizer",
         lambda: st.update(sym=model.encode(xt).symbols)),
        ("probclass bitcost", lambda: model.bitcost(
            centers_lookup(model.centers, st["sym"]), st["sym"])),
        ("decoder", lambda: st.update(x_dec=model.decode(
            centers_lookup(model.centers, st["sym"])))),
        ("search", lambda: st.update(
            y_syn=sifinder_lib.synthesize_side_image_prepped(
                st["x_dec"], prep, PH, PW, ae))),
        ("siNet", lambda: model.apply_sinet(st["x_dec"], st["y_syn"])),
    ]))
    q = centers_lookup(model.centers, st["sym"])
    det = {True: [], False: []}
    with torch.inference_mode():
        for flag in (True, False, False, True):
            torch.backends.cudnn.deterministic = flag
            det[flag].append(cuda_ms(lambda: model.decode(q), 5))
    torch.backends.cudnn.deterministic = True
    log(f"  decoder, batch of 4, device ms with cudnn.deterministic on "
        f"{det[True][0]:.2f}, {det[True][1]:.2f}; off {det[False][0]:.2f}, "
        f"{det[False][1]:.2f}")

    forward, (xe, ye) = entry(device=dev, full_width=True, batch=2, seed=seed)
    forward(xe, ye)                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    x_si, bpp_e = forward(xe, ye)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    entry_launches = dict(sk.launch_counts)
    if entry_launches["pearson_argmax"] < 1:
        raise AssertionError(f"entry did not launch the kernel: "
                             f"{entry_launches}")
    check_image("entry x_with_si", x_si, (2, H, W, 3), clipped=False)
    if not np.isfinite(float(bpp_e)):
        raise AssertionError("entry bpp not finite")
    log(f"  entry: batch 2 forward {1e3 * secs:.2f} ms, bpp "
        f"{float(bpp_e):.4f}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{entry_launches}")
    mask = sifinder_lib.standard_prior(H, W, PH, PW)   # as make_forward's
    log("  entry stages, batch 2, device ms: " + stage_ms([
        ("encode x+y", lambda: st.update(ex=model.encode(xe),
                                         ey=model.encode(ye))),
        ("decode x+y", lambda: st.update(x_dec=model.decode(st["ex"].qbar),
                                         y_dec=model.decode(st["ey"].qbar))),
        ("search", lambda: st.update(y_syn=sifinder_lib.synthesize_side_image(
            st["x_dec"], ye, st["y_dec"], mask, PH, PW, ae))),
        ("siNet", lambda: model.apply_sinet(st["x_dec"], st["y_syn"])),
        ("probclass bitcost", lambda: model.bitcost(st["ex"].qbar,
                                                    st["ex"].symbols)),
    ]))
    del mask

    # small input: kernel route on the card vs the plain route on the CPU
    fwd_gpu, (xs, ys) = entry(device=dev, seed=seed)
    fwd_cpu, _ = entry(device="cpu", seed=seed)
    out_gpu, bpp_gpu = fwd_gpu(xs, ys)
    out_cpu, bpp_cpu = fwd_cpu(xs.cpu(), ys.cpu())
    diff = float((out_gpu.cpu() - out_cpu).abs().max())
    if diff > 0.05 or abs(float(bpp_gpu) - float(bpp_cpu)) > 1e-4 * abs(
            float(bpp_cpu)):
        raise AssertionError(f"tiny forward: card vs CPU max diff {diff}, "
                             f"bpp {float(bpp_gpu)} vs {float(bpp_cpu)}")
    log(f"  tiny forward: card (kernel) vs CPU (plain) max |diff| {diff:.3g}"
        f" of 255, bpp {float(bpp_gpu):.6f} vs {float(bpp_cpu):.6f}")
    return {"pearson_argmax": entry_launches["pearson_argmax"],
            "pearson_argmax_shared": launches["pearson_argmax_shared"]}


def build_phase():
    """Build the four native libraries at once (one compiler each); print
    their build times and ptxas's register / spill lines."""
    with ThreadPoolExecutor(4) as pool:
        futs = {name: pool.submit(fn) for name, fn in (
            ("sifinder_argmax.cu", sk.load_library),
            ("probclass_front.cu", pk.load_library),
            ("decode_epilogue.cu", ek.load_library),
            ("range_coder.cpp", rans.load_library))}
        libs = {name: f.result() for name, f in futs.items()}
    for name, lib in libs.items():
        log(f"  {name}: {lib.build_seconds:.1f} s -> {lib.path}")
        for ln in getattr(lib, "ptxas_log", "").splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"    ptxas: {ln.strip()}")
    mma = k1_bench.sass_mma(libs["sifinder_argmax.cu"].path)
    if not mma.get("HMMA.1688.F32.TF32"):
        raise AssertionError(f"the search kernel's SASS has no TF32 tensor-"
                             f"core instruction: {mma}")
    log(f"  sifinder_argmax.cu SASS: {mma}")


def k3_bound(batch: int, params):
    """(bound_ms, bound_by) of one K3 call on `batch` blocks: the
    multiply-adds the logit rows need over the fp32 rate (each needed output
    of each layer over the taps its causality mask keeps and its inputs,
    `pk.needed_fmas`: 611,424 a block at C = 24, L = 6) vs the blocks, the
    compacted weights with their tables and the logits over the memory
    rate."""
    c, l_out = params.layout["channels"], params.layout["logits"]
    flops = 2.0 * batch * pk.needed_fmas(c, l_out)
    nbytes = 4 * (batch * int(np.prod(pk.CONTEXT)) + batch * l_out
                  + params.buffer.numel())
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3_phase(model, rng, dev, top: int):
    """K3 against its plain version on blocks drawn from the centers with
    the model's probclass weights; rows bit-identical across B; NaN in every
    input no logit needs changes no logit. Timed at `top`, the largest front
    of the path's volume and its largest bucket."""
    weights = [(torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev))
               for w, b in pc_lib.front_weight_matrices(model.probclass)]
    params = pk.prepare_front(weights)
    centers = model.centers.detach().cpu().numpy()
    batches = sorted(set(K3_BATCHES) | {top})
    n = max(batches)
    blocks = torch.from_numpy(rng.choice(centers, size=(n,) + pk.CONTEXT)
                              .astype(np.float32)).to(dev)
    full = pk.probclass_front_logits(blocks, params)
    err = 0.0
    for b in batches:
        got = pk.probclass_front_logits(blocks[:b].contiguous(), params)
        ref = pk.probclass_front_logits_reference(blocks[:b], weights)
        torch.testing.assert_close(got, ref, rtol=K3_RTOL, atol=K3_ATOL)
        if not torch.equal(got, full[:b]):
            raise AssertionError(f"K3 rows at B={b} differ from the same "
                                 f"rows at B={n}")
        err = max(err, float((got - ref).abs().max()))
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    if not torch.equal(pk.probclass_front_logits(
            blocks[perm.to(dev)].contiguous(), params), full[perm.to(dev)]):
        raise AssertionError("K3 rows depend on their batchmates' order")
    keep = torch.zeros(pk.CONTEXT, dtype=torch.bool)
    for p in pk.needed_positions(pk.KERNEL_SIZE)[0]:
        keep[p] = True
    drop = ~keep.to(dev)
    nan = pk.probclass_front_logits(blocks.masked_fill(drop, float("nan")),
                                    params)
    if not (torch.equal(nan, pk.probclass_front_logits(
            blocks.masked_fill(drop, 0.0), params)) and torch.equal(nan, full)):
        raise AssertionError("K3 logits change with NaN in the "
                             f"{int(drop.sum())} inputs no logit needs")

    timed_blocks = blocks[:top].contiguous()

    def yard():    # the yardstick: cuDNN conv3d through ResShallow
        with torch.inference_mode():
            return model.probclass(timed_blocks[:, None]).reshape(top, -1)

    torch.testing.assert_close(yard(), full[:top], rtol=1e-4, atol=1e-4)
    ms = cuda_ms(lambda: pk.probclass_front_logits(timed_blocks, params), 50)
    plain_ms = cuda_ms(
        lambda: pk.probclass_front_logits_reference(timed_blocks, weights), 10)
    lib_ms = cuda_ms(yard, 10)
    b_ms, b_by = k3_bound(top, params)
    log(f"  K3 vs plain at B={tuple(batches)}: max |kernel - plain| "
        f"{err:.3g} (rtol {K3_RTOL}, atol {K3_ATOL}); rows bit-identical "
        f"across B and under a permutation; NaN in the {int(drop.sum())} "
        f"unneeded inputs of each block changes no logit bit")
    log(f"  K3 at B={top}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (cuDNN conv3d ResShallow) {lib_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of bound")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def codec_path(server, codec, x, y, seed: int):
    """The codec path at full width; returns the K3 launches per pass."""
    symbols, bpp_est = server.encode(x)
    sym_np = symbols.cpu().numpy()
    vols = [np.ascontiguousarray(np.transpose(s, (2, 0, 1))) for s in sym_np]
    n_fronts = len(codec._wavefronts(*vols[0].shape))
    h, w = x.shape[1:3]
    decoded = {}
    pass_ms = []         # host-clock ms of each mode-3 encode / decode pass
    for i, vol in enumerate(vols):
        for mode in ("wavefront_pl", "wavefront_np"):
            k0 = pk.launch_counts["probclass_front_logits"]
            stream, enc_ms = timed(lambda: codec.encode(vol, mode=mode))
            k1 = pk.launch_counts["probclass_front_logits"]
            back, dec_ms = timed(lambda: codec.decode(stream))
            k2 = pk.launch_counts["probclass_front_logits"]
            per_pass = (k1 - k0, k2 - k1)
            want = (n_fronts, n_fronts) if mode == "wavefront_pl" else (0, 0)
            if per_pass != want:
                raise AssertionError(f"{mode}: K3 launches per pass "
                                     f"{per_pass}, expected {want}")
            if stream[5] != codec_lib._MODES[mode]:
                raise AssertionError(f"{mode}: header mode byte {stream[5]}")
            if not np.array_equal(back, vol):
                raise AssertionError(f"{mode}: volume {i} did not round-trip "
                                     f"({int((back != vol).sum())} symbols "
                                     f"differ)")
            gap = codec.coding_gap(vol, stream)
            if gap["gap_bits"] < -32:
                # the payload may undercut the bound by at most the 32-bit
                # coder state it opens with, whose start value is free
                raise AssertionError(f"{mode}: coding gap {gap} below the "
                                     f"-32-bit flush allowance")
            decoded.setdefault(mode, []).append(back)
            if mode == "wavefront_pl":
                pass_ms += [enc_ms, dec_ms]
            log(f"  volume {i} {vol.shape} {mode}: encode {enc_ms:.1f} ms, "
                f"decode {dec_ms:.1f} ms, {len(stream)} bytes = "
                f"{len(stream) * 8 / (h * w):.4f} bpp (probclass estimate "
                f"{float(bpp_est[i]):.4f}), coding gap "
                f"{gap['gap_pct']:.3f}%, K3 launches per pass {per_pass}")

    prep = server.open_session(y)
    for mode, backs in decoded.items():
        got = server.decode_si(np.stack([v.transpose(1, 2, 0)
                                         for v in backs]), prep)
        want = server.decode_si(sym_np, prep)
        if not torch.equal(got, want):
            raise AssertionError(f"decode_si on {mode}-decoded symbols is "
                                 f"not bit-equal to decode_si on the "
                                 f"originals")
    log("  decode_si on the decoded symbols (both modes) bit-equal to "
        "decode_si on the originals")

    x0 = x[0]
    blob, c_ms = timed(lambda: cli_lib.compress_array(x0, seed=seed))
    rec, d_ms = timed(lambda: cli_lib.decompress_array(blob))
    payload = cli_lib.parse_dsim(blob)[4]
    sym1 = codec.decode(payload)
    want_sym = server.encode(x0[None])[0][0].cpu().numpy().transpose(2, 0, 1)
    if not np.array_equal(sym1, want_sym):
        raise AssertionError("compress_array's symbols differ from "
                             "DeviceServer.encode's")
    with torch.inference_mode():
        x_dec = server.model.decode(centers_lookup(
            server.model.centers,
            torch.as_tensor(sym1.transpose(1, 2, 0)[None],
                            device=server.device)))
    want_rec = np.clip(x_dec[0].cpu().numpy(), 0, 255).astype(np.uint8)
    if not np.array_equal(rec, want_rec):
        raise AssertionError("decompress_array differs from the decoder on "
                             "the stream's symbols")
    rec_si, s_ms = timed(lambda: cli_lib.decompress_array(blob, side=y))
    want_si = server.decode_si(sym1.transpose(1, 2, 0)[None], prep)
    want_si = np.clip(want_si[0].cpu().numpy(), 0, 255).astype(np.uint8)
    if not np.array_equal(rec_si, want_si):
        raise AssertionError("decompress_array with side differs from "
                             "decode_si on the stream's symbols")
    log(f"  compress_array {c_ms:.0f} ms ({len(blob)} bytes), "
        f"decompress_array {d_ms:.0f} ms (= the decoder on the stream's "
        f"symbols), with side {s_ms:.0f} ms (= decode_si on them)")
    return n_fronts, vols[0].shape, float(np.median(pass_ms))


def k3_pass_breakdown(codec, shape, pass_ms, rng, dev):
    """K3 device ms of one mode-3 pass (CUDA events at each bucket size of
    the pass's fronts, each beside its bound, times their count) beside the
    pass's host-clock ms and the bound of the pass (each front's real
    blocks, no padding): the rest is host work per front."""
    fronts = codec._wavefronts(*shape)
    top = max(len(f) for f in fronts)
    buckets = collections.Counter(codec_lib.front_bucket(len(f), top)
                                  for f in fronts)
    params = codec._front_kernel_engine().params
    blocks = torch.from_numpy(rng.choice(codec.centers, size=(top,)
                                         + pk.CONTEXT).astype(np.float32))
    blocks = blocks.to(dev)
    per_bucket = {b: cuda_ms(lambda: pk.probclass_front_logits(
        blocks[:b], params), 50) for b in sorted(buckets)}
    log("  K3 per bucket (blocks: fronts in the pass, kernel ms, bound us, "
        "share of bound): " + "; ".join(
            f"{b}: {buckets[b]}, {ms:.4f}, {1e3 * k3_bound(b, params)[0]:.4f}"
            f", {100 * k3_bound(b, params)[0] / ms:.1f}%"
            for b, ms in per_bucket.items()))
    kernel_ms = sum(buckets[b] * ms for b, ms in per_bucket.items())
    host_ms = pass_ms - kernel_ms
    bound_ms = sum(k3_bound(len(f), params)[0] for f in fronts)
    log(f"  mode-3 pass of {len(fronts)} fronts, {sum(map(len, fronts))} "
        f"blocks (buckets {dict(sorted(buckets.items()))}): bound "
        f"{bound_ms:.3f} ms; K3 device {kernel_ms:.2f} ms of "
        f"{pass_ms:.1f} ms ({100 * kernel_ms / pass_ms:.1f}%); the rest, "
        f"{1e3 * host_ms / len(fronts):.0f} us per front, is host work "
        f"(block gather, copies, launch, softmax + tables, rANS)")


def codec_phase(seed: int, dev):
    rng = np.random.default_rng(seed + 2)
    ae, pc = full_configs()
    server = DeviceServer(ae, pc, device=dev, seed=seed)
    codec = make_codec(server.model)
    shape = (ae.num_chan_bn, H // 8, W // 8)
    top = max(len(f) for f in codec._wavefronts(*shape))
    row = k3_phase(server.model, rng, dev, top)
    imgs = smooth_images(rng, 2, extra_w=64)
    x = np.clip(imgs[:, :, :W] + rng.normal(0, 4, (2, H, W, 3)),
                0, 255).astype(np.float32)
    y = imgs[0, :, 16:16 + W].copy()
    sk.reset_launch_counts()
    pk.reset_launch_counts()
    rans.reset_native_call_counts()
    n_fronts, shape, pass_ms = codec_path(server, codec, x, y, seed)
    launches = dict(pk.launch_counts, **sk.launch_counts)
    log(f"  codec path launches {launches} ({n_fronts} fronts per pass; "
        f"mode 3 runs 3 passes per volume: encode, decode, coding gap), "
        f"native coder calls {rans.native_call_counts()}")
    k3_pass_breakdown(codec, shape, pass_ms, rng, dev)
    return row, launches["probclass_front_logits"]


def k4_bound(x: torch.Tensor, wmat: torch.Tensor):
    """(bound_ms, bound_by) of one K4 call: the deconv's multiply-adds (25
    taps x Cin x 3 per input position, 1,200 per output pixel at Cin 64)
    and a 30-operation tail per output pixel over the peak rate of the
    operand type (float32 outside the tensor cores, bfloat16 dense) vs x,
    wmat, the folded affine and both float32 images over the memory rate."""
    n, h2, w2, cin = x.shape
    flops = 2.0 * n * h2 * w2 * 25 * cin * 3 + 30.0 * n * 4 * h2 * w2
    peak = BF16_PEAK if x.dtype == torch.bfloat16 else FP32_PEAK
    nbytes = (x.numel() * x.element_size() + wmat.numel() * wmat.element_size()
              + 4 * 18 + 2 * 4 * n * 4 * h2 * w2 * 3)
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k4_phase(seed: int, dev):
    """K4 against its plain version on the full-width decoder's activation
    before its last deconv, with the weights folded from that decoder, in
    float32 and bfloat16; timed beside its bound and the library chain.
    Returns the float32 row of the kernels line."""
    rng = np.random.default_rng(seed + 3)
    ae, pc = full_configs()
    model = build_model(ae, pc, device=dev, seed=seed)
    epi = ek.fold_epilogue_params(model.decoder, ae.normalization)
    dec = model.decoder
    x = torch.from_numpy(np.clip(smooth_images(rng, 2) + rng.normal(
        0, 4, (2, H, W, 3)), 0, 255).astype(np.float32)).to(dev)
    with torch.inference_mode():
        q = centers_lookup(model.centers, model.encode(x).symbols)
        act = dec.conv1(dec.res(dec.conv0(q.permute(0, 3, 1, 2))))
        x_pre = act.permute(0, 2, 3, 1).contiguous()
        x_dec = model.decode(q)
    if tuple(x_pre.shape) != (2, H // 2, W // 2, 64):
        raise AssertionError(f"decoder activation {tuple(x_pre.shape)}")
    log(f"  K4 ptxas: {k4_bench.ptxas_summary(ek.load_library().ptxas_log)}")
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        xs, wmat = x_pre.to(dtype), epi.wmat.to(dtype)
        operands = (xs, wmat) + tuple(epi[1:])
        img, srch = ek.fused_decode_epilogue(*operands)
        ref_img, ref_srch = ek.epilogue_reference(*operands)
        torch.testing.assert_close(img, ref_img, rtol=K4_RTOL, atol=K4_ATOL)
        torch.testing.assert_close(srch, ref_srch, rtol=K4_RTOL,
                                   atol=K4_ATOL)
        err = max(float((img - ref_img).abs().max()),
                  float((srch - ref_srch).abs().max()))
        one = ek.fused_decode_epilogue(xs[1:].contiguous(), *operands[1:])
        if not (torch.equal(one[0], img[1:]) and torch.equal(one[1],
                                                             srch[1:])):
            raise AssertionError(f"K4 {dtype}: image 1 alone differs from "
                                 f"image 1 of the batch")
        deconv = dec.conv2.conv.weight.detach().to(dtype)
        with torch.inference_mode():
            library = leg_lib.epilogue_library(xs, deconv, epi._replace(
                wmat=wmat))
        if dtype == torch.float32:
            torch.testing.assert_close(img, x_dec, rtol=K4_RTOL, atol=K4_ATOL)
            torch.testing.assert_close(library[0], img, rtol=K4_RTOL,
                                       atol=K4_ATOL)
        inside = float(((ref_img > 0) & (ref_img < 255)).float().mean())
        ms = cuda_ms(lambda: ek.fused_decode_epilogue(*operands), 50)
        cold, flush = k4_bench.cold_ms(
            lambda: ek.fused_decode_epilogue(*operands))
        plain_ms = cuda_ms(lambda: ek.epilogue_reference(*operands), 10)
        lib_ms = cuda_ms(lambda: leg_lib.epilogue_library(
            xs, deconv, epi._replace(wmat=wmat)), 10)
        b_ms, b_by = k4_bound(xs, wmat)
        name = str(dtype).replace("torch.", "")
        log(f"  K4 {name} at {tuple(xs.shape)}: max |kernel - plain| "
            f"{err:.3g} (rtol {K4_RTOL}, atol {K4_ATOL}), {100 * inside:.1f}%"
            f" of pixels inside the clip, image 1 alone bit-equal to the "
            f"batch's; kernel {ms:.4f} ms warm, {cold:.4f} ms cold (L2 "
            f"flushed by a {k4_bench.FLUSH_BYTES >> 20} MiB write before each "
            f"launch, {flush:.4f} ms, subtracted), plain {plain_ms:.4f} ms, "
            f"library (conv_transpose2d chain) {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of bound warm, "
            f"{100 * b_ms / cold:.1f}% cold")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    log("  K4 float32 image vs the decoder's own output (conv2 + BN + "
        "denorm + clip): within the same bound")
    return rows["float32"]


def leg_phase(seed: int, dev) -> int:
    """The serve-bench precision leg at full width; returns K4's launches
    in it."""
    sk.reset_launch_counts()
    pk.reset_launch_counts()
    ek.reset_launch_counts()
    t0 = time.perf_counter()
    section = leg_lib.run_precision_section(
        config_path("ae_kitti_stereo"), config_path("pc_default"), (H, W),
        LEG_REPS, seed=seed, device=dev)
    secs = time.perf_counter() - t0
    launches = dict(sk.launch_counts, **pk.launch_counts, **ek.launch_counts)
    violations = leg_lib.gate_precision(section)
    if violations:
        raise AssertionError(f"precision leg: {violations}")
    for name in ("pearson_argmax_shared", "probclass_front_logits",
                 "fused_decode_epilogue"):
        if launches[name] < 1:
            raise AssertionError(f"the precision leg did not launch {name}: "
                                 f"{launches}")
    log(f"  precision leg at {H}x{W}, batch {section['batch']}, median of "
        f"{section['reps']} (CUDA events), {secs:.1f} s, launches {launches}")
    log("  stage ms: " + " | ".join(
        f"{rung}: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                entry["stage_device_ms"].items())
        for rung, entry in section["per_rung"].items()))
    if seed == 0:
        for rung, entry in section["per_rung"].items():
            for mode, pin in STREAM_PINS.items():
                if not entry["stream_sha256"][mode].startswith(pin):
                    raise AssertionError(
                        f"precision leg {rung} {mode} stream sha256 "
                        f"{entry['stream_sha256'][mode][:16]}, pinned {pin}")
    digests = section["per_rung"]["fp32"]["stream_sha256"]
    log(f"  streams byte-identical across {section['rungs']}: "
        + ", ".join(f"{m} {digests[m][:16]}" for m in leg_lib.MODES)
        + ("" if seed else " (the pinned prefixes)")
        + "; every stream round-trips; steady builds "
        + str({r: e["steady_builds"]
               for r, e in section["per_rung"].items()}))
    return launches["fused_decode_epilogue"]


TEST_PAIRS, KITTI_H, KITTI_W = 4, 375, 1242
# Lower bound of a test image's coding gap, as a share of its ideal bits.
# One rANS step sets x' = floor(x/f)*M + x mod f + c, which can fall below
# x*M/f by up to M - f, so one message's payload can undercut its ideal
# length by more than the 32-bit state flush, and by more the more symbols
# it holds: the JAX package's own coder, on the CPU, gives a mode-2 stream
# more than 32 bits under its ideal on image 2 of this split at the default
# seed (the port's stream is byte-identical). The exact round trip is
# checked beside it.
GAP_FLOOR_SHARE = 2e-4


def checkpoint_checks(model, ae, pc, ckpt_dir: str, seed: int, dev):
    """Save the model, restore it bit-equal into another with the manifest
    verified, and refuse a copy with one flipped byte of array data.
    Returns (save ms, restore ms, checkpoint bytes)."""
    state = ckpt_lib.state_from_model(model)
    t0 = time.perf_counter()
    ckpt_lib.save_checkpoint(ckpt_dir, state, manifest_extra={
        "pc_config_sha256": ckpt_lib.config_sha256(pc), "seed": seed})
    save_ms = 1e3 * (time.perf_counter() - t0)
    other = build_model(ae, pc, device=dev, seed=seed + 2)
    t0 = time.perf_counter()
    info = restore_checkpoint(other, ckpt_dir)
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    if info["status"] != "verified":
        raise AssertionError(f"the manifest did not verify: {info['status']}")
    want, got = model.state_dict(), other.state_dict()
    if set(want) != set(got) or not all(torch.equal(want[k], got[k])
                                        for k in want):
        raise AssertionError("the restored state_dict differs from the saved "
                             "model's")
    tampered = ckpt_dir + ".tampered"
    shutil.copytree(ckpt_dir, tampered)
    path = os.path.join(tampered, "params_decoder.msgpack")
    with open(path, "r+b") as f:
        f.seek(-5, os.SEEK_END)          # inside the last kernel's floats
        byte = f.read(1)
        f.seek(-5, os.SEEK_END)
        f.write(bytes([byte[0] ^ 1]))
    try:
        restore_checkpoint(build_model(ae, pc, device=dev, seed=seed), tampered)
    except ckpt_lib.ManifestMismatch as e:
        log(f"  tampered decoder partition refused: {str(e)[:90]}...")
    else:
        raise AssertionError("a flipped byte in params_decoder.msgpack "
                             "loaded without ManifestMismatch")
    nbytes = sum(v["bytes"] for v in info["manifest"]["files"].values())
    return save_ms, restore_ms, nbytes


def test_run_phase(seed: int, dev):
    """The test entry point at full width from a checkpoint the port wrote;
    returns the K1 and K3 launches of the run."""
    ae, pc = full_configs()
    h, w = ae.eval_crop_size
    ph, pw = ae.y_patch_size
    with tempfile.TemporaryDirectory(prefix="dsin-test-run-") as root:
        t0 = time.perf_counter()
        manifests = synthetic.write_corpus(root, 0, 0, TEST_PAIRS, KITTI_H,
                                           KITTI_W, seed=seed)
        os.rename(manifests["test"], os.path.join(root, "test.txt"))
        corpus_s = time.perf_counter() - t0
        cfg = ae.replace(load_model=True, load_train_step=False,
                         train_model=False, test_model=True,
                         root_data=root, file_path_test="test.txt")
        name = ckpt_lib.model_name_for(cfg, "smoke")
        cfg = cfg.replace(load_model_name=name)
        # seeded apart from the run's own init (seed 0), so the restore
        # visibly replaces every weight
        model = build_model(cfg, pc, device=dev, seed=seed + 1)
        save_ms, restore_ms, nbytes = checkpoint_checks(
            model, cfg, pc, os.path.join(root, "weights", name), seed, dev)
        log(f"  {TEST_PAIRS} synthetic pairs at {KITTI_H}x{KITTI_W} written "
            f"in {corpus_s:.1f} s; checkpoint of {nbytes} bytes: save "
            f"{save_ms:.1f} ms, restore + manifest check {restore_ms:.1f} ms,"
            f" state_dict bit-equal")

        records = []
        sk.reset_launch_counts()
        pk.reset_launch_counts()
        t0 = time.perf_counter()
        results = main_lib.run(
            cfg, pc, out_root=root, real_bpp=True, device=dev,
            on_image=lambda exp, i, rec: records.append((exp, i, rec)))
        run_s = time.perf_counter() - t0
        launches = {"pearson_argmax": sk.launch_counts["pearson_argmax"],
                    "probclass_front_logits":
                        pk.launch_counts["probclass_front_logits"]}
        exp = records[0][0]
        if len(records) != TEST_PAIRS:
            raise AssertionError(f"the test loop scored {len(records)} images")
        if exp.eval_mask is None or exp.eval_mask.factors is None:
            raise AssertionError("the eval prior did not check as the "
                                 "standard Gaussian")
        codec = make_codec(model)
        fronts = len(codec._wavefronts(ae.num_chan_bn, h // 8, w // 8))
        if launches != {"pearson_argmax": TEST_PAIRS,
                        "probclass_front_logits": TEST_PAIRS * fronts}:
            raise AssertionError(f"test-run launches {launches}, expected "
                                 f"one K1 per image and one K3 per front "
                                 f"({fronts} a volume)")
        want_sd = model.state_dict()
        if not all(torch.equal(v, want_sd[k])
                   for k, v in exp.model.state_dict().items()):
            raise AssertionError("the run's restored weights differ from "
                                 "the saved model's")

        forward = make_forward(model, h, w)
        pairs = read_pair_manifest(os.path.join(root, "test.txt"), root)
        bpps = ScoreLists.load_list(exp.images_dir, "bpp", exp.model_name)
        reals = ScoreLists.load_list(exp.images_dir, "real_bpp",
                                     exp.model_name)
        stage = collections.defaultdict(list)
        for _, i, rec in records:
            out = rec["out"]
            x_si, bpp = forward(rec["x"], rec["y"])
            if not (np.array_equal(out["x_with_si"], x_si.cpu().numpy())
                    and float(out["bpp"]) == float(bpp)):
                raise AssertionError(
                    f"image {i}: the test loop's x_with_si / bpp differ from "
                    f"entry.make_forward's (max |diff| "
                    f"{np.abs(out['x_with_si'] - x_si.cpu().numpy()).max()}, "
                    f"bpp {float(out['bpp'])} vs {float(bpp)})")
            check_image(f"test image {i}", torch.from_numpy(out["x_with_si"]),
                        (1, h, w, 3), clipped=False)
            vol = np.ascontiguousarray(np.transpose(out["symbols"][0],
                                                    (2, 0, 1)))
            stream = codec.encode(vol, mode="wavefront_pl")
            real = len(stream) * 8.0 / (h * w)
            gap = codec.coding_gap(vol, stream)
            if real != reals[i] or bpps[i] != float(out["bpp"]):
                raise AssertionError(f"image {i}: score lists hold bpp "
                                     f"{bpps[i]}, real {reals[i]}; the run "
                                     f"gave {float(out['bpp'])}, {real}")
            if gap["gap_bits"] < -32 - GAP_FLOOR_SHARE * gap["ideal_bits"]:
                raise AssertionError(f"image {i}: coding gap {gap} below "
                                     f"-32 bits - {GAP_FLOOR_SHARE} of the "
                                     f"ideal")
            if not np.array_equal(codec.decode(stream), vol):
                raise AssertionError(f"image {i}: the mode-3 stream does not "
                                     f"decode to its symbols")
            want_png = np.clip(out["x_with_si"][0], 0, 255).astype(np.uint8)
            path = os.path.join(exp.images_dir, f"{i}_{bpps[i]:.4f}bpp.png")
            if not np.array_equal(png.read_png(path), want_png):
                raise AssertionError(f"{path} does not read back bit-equal")
            t0 = time.perf_counter()
            for p in pairs[i]:
                png.read_png(p)
            stage["png_decode_pair"].append(1e3 * (time.perf_counter() - t0))
            for k, v in rec["ms"].items():
                stage[k].append(v)
            log(f"  image {i}: bpp {bpps[i]:.4f}, real {reals[i]:.4f} (gap "
                f"{gap['gap_bits']:.1f} bits, exact round trip), psnr "
                f"{rec['scores']['psnr']:.2f}, ms-ssim "
                f"{rec['scores']['ms_ssim']:.4f}; x_with_si and bpp "
                f"bit-equal to entry.make_forward")
        for metric in ScoreLists.METRICS:
            if len(ScoreLists.load_list(exp.images_dir, metric,
                                        exp.model_name)) != TEST_PAIRS:
                raise AssertionError(f"score list {metric} incomplete")
        log(f"  test run {run_s:.1f} s, launches {launches} ({fronts} fronts "
            f"a volume); means {json.dumps(results)}")
        gh, gw = exp.eval_mask.factors
        log(f"  eval prior at {h}x{w}, {ph}x{pw} patches, held as its "
            f"factors ({(gh.nbytes + gw.nbytes) / 1e6:.2f} MB, not the "
            f"{4 * gh.shape[0] * gw.shape[0] * gh.shape[1] / 1e9:.2f} GB "
            f"product); restore in the run {exp.restore_ms:.1f} ms")
        log("  per-image ms (host clock; forward includes the pull of its "
            "outputs): " + ", ".join(
                f"{k} " + "/".join(f"{v:.1f}" for v in vals)
                for k, vals in stage.items()))
    return launches


# -- phase 8: training at full width ----------------------------------------

TRAIN_PAIRS, VAL_PAIRS, RUN_TEST_PAIRS = 4, 2, 2
RUN_STEPS, RESUME_STEPS, RUN_EVERY = 6, 2, 4
TIMED_STEPS = 5


def train_configs(**over):
    """ae_kitti_stereo + pc_default as they train: batch 1 at the 320x960
    crop."""
    ae, pc = full_configs()
    return (ae.replace(**over) if over else ae), pc


def train_crops(seed: int, n: int, crop):
    """n seeded random crops (with flips) of synthetic KITTI-sized stereo
    pairs, the loader's own cropping: (x, y) float32 batches of one."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        left, right = synthetic.make_stereo_pair(rng, KITTI_H, KITTI_W)
        (crop6,) = random_pair_crops(np.concatenate([left, right], -1),
                                     crop[0], crop[1], 1, True, rng)
        out.append((crop6[None, ..., :3].astype(np.float32),
                    crop6[None, ..., 3:].astype(np.float32)))
    return out


def trainer(ae, pc, dev, seed: int, mask, on_phase=None):
    """A seeded model, its optimizer and its train step."""
    model = build_model(ae, pc, device=dev, seed=seed)
    optimizer = optim_lib.Optimizer(model, ae, pc,
                                    main_lib.DEFAULT_NUM_TRAIN_IMGS)
    step = step_lib.make_train_step(model, optimizer, si_mask=mask,
                                    on_phase=on_phase)
    return model, optimizer, step


def snapshot(model, optimizer):
    """Every tensor of the training state, cloned: parameters, running
    statistics, gradients, moments and step counts."""
    out = {f"state/{k}": v.detach().clone()
           for k, v in model.state_dict().items()}
    out.update({f"grad/{n}": p.grad.detach().clone()
                for n, p in model.named_parameters() if p.grad is not None})
    for label, group in optimizer.groups.items():
        for slot, tensors in group.slots.items():
            out.update({f"{label}/{slot}/{n}": t.detach().clone()
                        for n, t in tensors.items()})
        out[f"{label}/count"] = torch.tensor(group.count)
    return out


def assert_bit_equal(a: dict, b: dict, what: str):
    if set(a) != set(b):
        raise AssertionError(f"{what}: different tensors "
                             f"{sorted(set(a) ^ set(b))[:4]}")
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    if bad:
        diff = {k: float((a[k].double() - b[k].double()).abs().max())
                for k in bad}
        worst = max(diff, key=diff.get)
        raise AssertionError(f"{what}: {len(bad)} of {len(a)} tensors "
                             f"differ, the most {worst} by {diff[worst]:.3g}")


def k1_at_training_shape(seed: int, dev, crop):
    """K1 against its plain version at batch 1 on the training crop with
    the Gaussian prior; its time beside its bound and the library call."""
    rng = np.random.default_rng(seed + 4)
    h, w = crop
    x = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
    ops = operands(x, y, True, dev)
    err = check_agreement(f"pearson_argmax random+prior b=1 {h}x{w}", ops,
                          sk.pearson_argmax(*ops, PH, PW),
                          sk.pearson_argmax_reference(*ops, PH, PW))
    ms = cuda_ms(lambda: sk.pearson_argmax(*ops, PH, PW), 5)
    plain_ms = cuda_ms(lambda: sk.pearson_argmax_reference(*ops, PH, PW), 2)
    lib_ms = cuda_ms(lambda: k1_bench.library_argmax(ops, PH, PW, False), 2)
    _, _, bnds = bound(ops, False)
    p = ops[1].shape[1]
    hc, wc = ops[2].shape[-2:]
    log(f"  K1 at the training shape (batch 1, {h}x{w}, P = {p}, a {hc}x{wc}"
        f" map): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
        f"{lib_ms:.3f} ms, {bound_text(bnds, ms)}, max |val - plain| "
        f"{err:.3g}")


def search_operands(model, x, y):
    """The train step's search inputs: x-hat of the train-mode forward,
    y-hat of the side image's inference forward."""
    with torch.no_grad():
        x_dec = model.decode(model.encode(x, True).qbar, True)
        y_dec = model.decode(model.encode(y).qbar)
    return x_dec, y_dec


def one_step_checks(seed: int, dev, ae, pc, mask, batches):
    """The first train step at full width through K1, then the same step
    with the search's plain version on the card, and with frozen
    statistics. Returns the kernel route's (model, optimizer, step)."""
    x, y = batches[0]
    model, optimizer, step = trainer(ae, pc, dev, seed, mask)
    before = snapshot(model, optimizer)
    sk.reset_launch_counts()
    _, metrics = step(x, y)
    torch.cuda.synchronize()
    launches = dict(sk.launch_counts)
    if launches != {"pearson_argmax": 1, "pearson_argmax_shared": 0}:
        raise AssertionError(f"one train step launched {launches}")
    scalars = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in scalars.values()):
        raise AssertionError(f"non-finite train metrics {scalars}")
    after = snapshot(model, optimizer)
    trained = [n for n, label in optimizer.labels.items()
               if label != "frozen"]
    still = [n for n in trained
             if torch.equal(before[f"state/{n}"], after[f"state/{n}"])]
    if still:
        raise AssertionError(f"{len(still)} trained parameters did not "
                             f"move: {still[:4]}")
    stats = [k for k in before if "running_" in k]
    unmoved = [k for k in stats if torch.equal(before[k], after[k])]
    if unmoved:
        raise AssertionError(f"{len(unmoved)} running statistics did not "
                             f"move: {unmoved[:4]}")
    log(f"  one step at {x.shape[1]}x{x.shape[2]}, batch 1: K1 launched "
        f"once; all {len(trained)} trained parameters and {len(stats)} "
        f"running statistics moved; " + ", ".join(
            f"{k} {v:.4f}" for k, v in scalars.items()))

    # the same step with the search's plain version on the card
    model_p, optimizer_p, step_p = trainer(
        ae.replace(sifinder_impl="torch"), pc, dev, seed, mask)
    x_t, y_t = (torch.from_numpy(t).to(dev) for t in (x, y))
    x_dec, y_dec = search_operands(model_p, x_t, y_t)
    ops = operands(x_dec, y_dec, True, dev)
    got = sk.pearson_argmax(*ops, PH, PW)
    ref = sk.pearson_argmax_reference(*ops, PH, PW)
    check_agreement("the step's own search operands, K1 vs plain", ops, got,
                    ref)
    all_equal = torch.equal(got[1], ref[1])
    syn = {impl: sifinder_lib.synthesize_side_image(
        x_dec, y_t, y_dec, mask, PH, PW, ae.replace(sifinder_impl=impl))
        for impl in ("kernel", "torch")}
    _, metrics_p = step_p(x, y)
    torch.cuda.synchronize()
    if all_equal:
        if not torch.equal(syn["kernel"], syn["torch"]):
            raise AssertionError("equal indices, different y_syn")
        if float(metrics_p["loss"]) != scalars["loss"]:
            raise AssertionError(f"loss {float(metrics_p['loss'])} (plain "
                                 f"search) vs {scalars['loss']} (K1)")
        assert_bit_equal(after, snapshot(model_p, optimizer_p),
                         "the step through K1 vs through the plain search")
        log("  the same step with the plain search on the card: every index "
            "equal; y_syn, the loss, every gradient, the new parameters, "
            "statistics and moments bit-equal")
    else:
        log(f"  the same step with the plain search on the card: "
            f"{int((got[1] != ref[1]).sum())} indices differ, all within the "
            f"{MARGIN_ATOL} top-two margin; loss "
            f"{float(metrics_p['loss']):.6f} vs {scalars['loss']:.6f}")
    del model_p, optimizer_p, step_p

    # bn_stats = 'frozen': batch statistics normalize, nothing is recorded
    model_f, optimizer_f, step_f = trainer(ae.replace(bn_stats="frozen"),
                                           pc, dev, seed, mask)
    frozen_before = snapshot(model_f, optimizer_f)
    step_f(x, y)
    frozen_after = snapshot(model_f, optimizer_f)
    moved = [k for k in stats if not torch.equal(frozen_before[k],
                                                 frozen_after[k])]
    if moved:
        raise AssertionError(f"bn_stats = 'frozen' moved {moved[:4]}")
    log("  bn_stats = 'frozen': the running statistics unchanged")
    return model, optimizer, step


def determinism_and_resume(seed: int, dev, ae, pc, mask, batches, first,
                           root: str):
    """The first step again from the same state (bit-equal), then a save at
    step 1 with its optimizer state, a restore into a model of another seed
    with load_train_step, and step 2 there against the uninterrupted step 2
    (bit-equal)."""
    model, optimizer, step = first
    model_c, optimizer_c, step_c = trainer(ae, pc, dev, seed, mask)
    step_c(*batches[0])
    torch.cuda.synchronize()
    assert_bit_equal(snapshot(model, optimizer),
                     snapshot(model_c, optimizer_c),
                     "the same step twice from the same state")
    ckpt = os.path.join(root, "weights", "step1")
    t0 = time.perf_counter()
    ckpt_lib.save_checkpoint(ckpt, ckpt_lib.state_from_model(
        model_c, optimizer=optimizer_c))
    save_ms = 1e3 * (time.perf_counter() - t0)
    model_d, optimizer_d, step_d = trainer(ae, pc, dev, seed + 7, mask)
    t0 = time.perf_counter()
    state = ckpt_lib.restore_for_mode(
        ckpt, ckpt_lib.state_from_model(model_d, optimizer=optimizer_d),
        ae.replace(load_model=True, load_train_step=True))
    ckpt_lib.load_state(model_d, state, optimizer_d)
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    if optimizer_d.step != 1:
        raise AssertionError(f"restored step {optimizer_d.step}")
    step(*batches[1])
    step_d(*batches[1])
    torch.cuda.synchronize()
    assert_bit_equal(snapshot(model, optimizer), snapshot(model_d,
                                                          optimizer_d),
                     "step 2 after a save and restore vs step 2 "
                     "uninterrupted")
    nbytes = sum(os.path.getsize(os.path.join(ckpt, f))
                 for f in os.listdir(ckpt))
    log(f"  determinism: the same step twice from one state, bit-equal "
        f"(parameters, statistics, gradients, moments); resume: saved at "
        f"step 1 with opt_state.msgpack ({nbytes} bytes, {save_ms:.1f} ms), "
        f"restored into a model of another seed with load_train_step "
        f"({restore_ms:.1f} ms): step 2 bit-equal to the uninterrupted one")


def run_phase(seed: int, dev, root: str):
    """`main.run` with train_model and test_model on a synthetic split of
    KITTI-sized pairs, then a resumed run; launch counts read around each."""
    t0 = time.perf_counter()
    manifests = synthetic.write_corpus(root, TRAIN_PAIRS, VAL_PAIRS,
                                       RUN_TEST_PAIRS, KITTI_H, KITTI_W,
                                       seed=seed)
    for split, path in manifests.items():
        os.rename(path, os.path.join(root, f"{split}.txt"))
    corpus_s = time.perf_counter() - t0
    ae, pc = train_configs(
        root_data=root, file_path_train="train.txt",
        file_path_val="val.txt", file_path_test="test.txt", test_model=True,
        validate_every=RUN_EVERY, checkpoint_every=RUN_EVERY,
        decrease_val_steps=False, show_every=2)
    h, w = ae.eval_crop_size
    fronts = len(make_codec(build_model(ae, pc, device="cpu"))._wavefronts(
        ae.num_chan_bn, h // 8, w // 8))
    runs = []
    trace_dir, peer = os.path.join(root, "trace"), os.path.join(root, "peer")
    for steps in (RUN_STEPS, RESUME_STEPS):
        cfg = ae if not runs else ae.replace(
            load_model=True, load_train_step=True,
            load_model_name=runs[0]["exp"].model_name)
        seen = []
        sk.reset_launch_counts()
        pk.reset_launch_counts()
        t0 = time.perf_counter()
        results = main_lib.run(
            cfg, pc, out_root=root, max_steps=steps, real_bpp=True,
            profile_dir=None if runs else trace_dir,
            replicate_to=None if runs else peer,
            device=dev, on_image=lambda exp, i, rec: seen.append(exp))
        secs = time.perf_counter() - t0
        launches = {"pearson_argmax": sk.launch_counts["pearson_argmax"],
                    "probclass_front_logits":
                        pk.launch_counts["probclass_front_logits"]}
        if len(seen) != RUN_TEST_PAIRS or results["steps"] != steps:
            raise AssertionError(f"run: {results['steps']} steps, "
                                 f"{len(seen)} test images")
        exp = seen[0]
        runs.append(dict(exp=exp, results=results))
        start = exp.step - steps
        validations = sum(1 for j in range(start, exp.step)
                          if (j + 1) % RUN_EVERY == 0 or j + 1 == exp.step)
        want = {"pearson_argmax": steps + validations * VAL_PAIRS
                + RUN_TEST_PAIRS,
                "probclass_front_logits": RUN_TEST_PAIRS * fronts}
        if launches != want:
            raise AssertionError(f"run of {steps} steps from step {start}: "
                                 f"launches {launches}, expected {want} "
                                 f"({validations} validations of "
                                 f"{VAL_PAIRS} batches, {RUN_TEST_PAIRS} "
                                 f"test images, {fronts} fronts each)")
        if not np.isfinite(results["best_val"]):
            raise AssertionError(f"best_val {results['best_val']}")
        log(f"  run from step {start}: {steps} steps, {validations} "
            f"validations, {RUN_TEST_PAIRS} test images with real bpp in "
            f"{secs:.1f} s; launches {launches} (= steps + validation "
            f"batches + test images, and {fronts} fronts an image); best_val "
            f"{results['best_val']:.4f}, test bpp {results['bpp']:.4f} (real "
            f"{results['real_bpp']:.4f}), psnr {results['psnr']:.2f}")
    first, second = runs
    ckpt = first["exp"].ckpt_dir
    meta = ckpt_lib.load_meta(ckpt)
    files = ckpt_lib.load_manifest(ckpt)["files"]
    periodic = ckpt_lib.load_meta(os.path.join(ckpt, "periodic"))
    if ("opt_state.msgpack" not in files
            or periodic.get("kind") != "periodic"
            or meta["best_val"] != first["results"]["best_val"]):
        raise AssertionError(f"checkpoints: files {sorted(files)}, periodic "
                             f"{periodic}, meta {meta}")
    if (second["exp"].step != RUN_STEPS + RESUME_STEPS
            or second["exp"].restored_best_val != meta["best_val"]):
        raise AssertionError(f"resume: step {second['exp'].step}, best_val "
                             f"{second['exp'].restored_best_val} vs "
                             f"{meta['best_val']}")
    nbytes = sum(f["bytes"] for f in files.values())
    log(f"  {TRAIN_PAIRS}/{VAL_PAIRS}/{RUN_TEST_PAIRS} synthetic pairs at "
        f"{KITTI_H}x{KITTI_W} written in {corpus_s:.1f} s; a best-val "
        f"checkpoint (step {meta['step']}, {nbytes} bytes with "
        f"opt_state.msgpack) and a periodic one; the resumed run continued "
        f"at step {RUN_STEPS}, read best_val {meta['best_val']:.4f}, and "
        f"restore_best_for_test scored the test split")
    trace_checks(trace_dir)
    replica_checks(first["exp"], peer)


def trace_checks(trace_dir: str) -> None:
    """The first run's --profile_dir trace: the window's 3 train_step
    annotations, K1 once inside each and once per validation batch
    processed while the window was open, device events; prints the
    kernels with the most device time and what launched them."""
    (name,) = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    path = os.path.join(trace_dir, name)
    t0 = time.perf_counter()
    summary = profiling.trace_summary(path)
    read_s = time.perf_counter() - t0
    first = min(5, max(RUN_STEPS - 3, 0))
    window = list(range(first, first + 3))
    # metrics lag one step: step j is processed (and validated) after step
    # j+1 is dispatched, so from step first-1 on inside the window
    validations = sum(1 for j in range(first - 1, RUN_STEPS)
                      if (j + 1) % RUN_EVERY == 0 or j + 1 == RUN_STEPS)
    k1 = [row for kname, row in summary["kernels"].items()
          if "pearson_argmax_tc" in kname]
    count = sum(row["count"] for row in k1)
    attributed = sum(row["attributed"] for row in k1)
    in_steps = sum(row["launches_in_steps"] for row in k1)
    want = len(window) + validations * VAL_PAIRS
    if summary["annotations"] != window or count != want \
            or not summary["device_events"]:
        raise AssertionError(
            f"trace {path}: annotations {summary['annotations']} (expected "
            f"{window}), K1 {count} (expected {want}: one a traced step and "
            f"{validations} validations of {VAL_PAIRS} batches), "
            f"{summary['device_events']} device events")
    if attributed == count and in_steps != len(window):
        raise AssertionError(f"trace {path}: K1 launched {in_steps} times "
                             f"inside the train_step annotations")
    log(f"  profile_dir: {os.path.getsize(path) / 2 ** 20:.1f} MiB Chrome "
        f"trace of steps {window} (read in {read_s:.1f} s), "
        f"{summary['device_events']} device events; K1 {count} kernels = "
        f"{len(window)} steps + {validations} x {VAL_PAIRS} validation "
        f"batches, " + (f"{in_steps} launched inside the step annotations"
                        if attributed == count else
                        f"{attributed} of {count} with a launch record"))
    top = sorted(summary["kernels"].items(), key=lambda kv: kv[1]["us"],
                 reverse=True)[:10]
    log(f"  the trace's 10 kernels with the most device time (card "
        f"{card_line()}), each with the operators that launched it:")
    for kname, row in top:
        ops = row["ops"].most_common(2)
        log(f"    {row['us'] / 1e3:9.2f} ms x{row['count']:<4d} "
            f"{kname[:70]} <- " + "; ".join(
                f"{op[:150]} ({us / 1e3:.2f} ms)" for op, us in ops))


def replica_checks(exp, peer: str) -> None:
    """The first run's --replicate_to copy: its files match its manifest's
    CRCs and its params_digest is the source's; a second (forced) best-val
    save rotates it aside to .prev-*."""
    replica = os.path.join(peer, exp.model_name)
    manifest = ckpt_lib.load_manifest(replica)
    files = ckpt_lib.verify_files(replica, manifest)
    source = ckpt_lib.load_manifest(exp.ckpt_dir)
    if manifest != source:
        raise AssertionError(f"replica {replica}: manifest differs from the "
                             f"checkpoint's (params_digest "
                             f"{manifest.get('params_digest')} vs "
                             f"{source.get('params_digest')})")
    t0 = time.perf_counter()
    exp._validate_and_maybe_save(exp.step - 1, exp.step, float("inf"), [],
                                 JsonlLogger(None), 1, force_save=True)
    save_s = time.perf_counter() - t0
    prevs = ckpt_lib._prev_dirs(peer, exp.model_name)
    again = ckpt_lib.load_manifest(replica)
    if (len(prevs) != 1 or ckpt_lib.load_manifest(prevs[0]) != manifest
            or again != ckpt_lib.load_manifest(exp.ckpt_dir)):
        raise AssertionError(f"replica {replica}: after a second best-val "
                             f"save, .prev dirs {prevs}")
    ckpt_lib.verify_files(replica, again)
    log(f"  replicate_to: {files['files']} files, {files['bytes']} bytes, "
        f"CRCs and params_digest {manifest['params_digest'][:16]} equal to "
        f"the checkpoint's; a forced best-val save (validation, save and "
        f"replication {save_s:.2f} s) rotated the replica to "
        f"{os.path.basename(prevs[0])}")


def time_train_step(dev, ae, pc, mask, batches, label: str):
    """ms per train step (host clock around synchronised steps, median of
    the warm ones), its forward / backward / optimizer split (CUDA events
    from the step's phase hook) and the peak device memory of a step."""
    marks = []

    def on_phase(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    _, _, step = trainer(ae, pc, dev, 0, mask, on_phase=on_phase)
    for x, y in batches[:2]:                  # warm-up: cuDNN plans, K1
        step(x, y)
    torch.cuda.synchronize()
    host, split = [], collections.defaultdict(list)
    for i in range(TIMED_STEPS):
        x, y = batches[i % len(batches)]
        marks.clear()
        torch.cuda.reset_peak_memory_stats()
        on_phase("start")
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
        for (_, a), (name, b) in zip(marks, marks[1:]):
            split[name].append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = {k: float(np.median(v)) for k, v in split.items()}
    log(f"  {label}: {float(np.median(host)):.2f} ms per step (median of "
        f"{TIMED_STEPS} warm, host clock: "
        + "/".join(f"{v:.1f}" for v in host) + "); device ms forward "
        f"{med['forward']:.2f}, backward {med['backward']:.2f}, optimizer "
        f"{med['optimizer']:.2f}; peak {peak:.2f} GiB")
    profile_step(step, *batches[0], float(np.median(host)))


def profile_step(step, x, y, step_ms: float):
    """One more step under torch.profiler: its kernel time on the device,
    that time's share of the median step, and the kernels that take most
    of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        step(x, y)
        torch.cuda.synchronize()
    # the kernels themselves: an operator's own entry counts its kernels'
    # time again
    events = [e for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU]

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    total = sum(device_us(e) for e in events) / 1e3
    if total <= 0:
        log("  torch.profiler saw no device time on this card")
        return
    top = sorted(events, key=device_us, reverse=True)[:8]
    log(f"  profiled step: {total:.2f} ms of kernels on the device, "
        f"{100 * total / step_ms:.1f}% of the {step_ms:.2f} ms step; most: "
        + "; ".join(f"{e.key[:48]} x{e.count} {device_us(e) / 1e3:.2f} ms"
                    for e in top))


def train_phase(seed: int, dev):
    ae, pc = train_configs()
    crop = tuple(ae.crop_size)
    k1_at_training_shape(seed, dev, crop)
    mask = sifinder_lib.check_mask(torch.as_tensor(
        sifinder_lib.gaussian_position_mask(crop[0], crop[1], PH, PW),
        device=dev), PH, PW)
    if mask.factors is None:
        raise AssertionError("the training prior did not check as the "
                             "standard Gaussian")
    batches = train_crops(seed + 5, 3, crop)
    first = one_step_checks(seed, dev, ae, pc, mask, batches)
    with tempfile.TemporaryDirectory(prefix="dsin-train-") as root:
        determinism_and_resume(seed, dev, ae, pc, mask, batches, first, root)
        del first
        run_phase(seed, dev, root)
    time_train_step(dev, ae, pc, mask, batches, "float32 train step")
    time_train_step(dev, ae.replace(compute_dtype="bfloat16"), pc, mask,
                    batches, "bfloat16 train step (compute_dtype)")


# -- phase 9: the rest of the patch search, the Cityscapes geometry ---------

SCORE_ATOL = 1e-5          # winning scores of two search routes
CS_STEPS = 3               # timed Cityscapes train steps after one warm-up


def peak_above(fn):
    """(fn(), peak device bytes above what was allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def map_disagreements(score_map, idx, best_val, best_idx, margin):
    """(P,) bool: where `idx` differs from `best_idx` AND the materialized
    map's score at `idx` falls short of `best_val` by more than `margin`."""
    flat = score_map.reshape(-1, score_map.shape[-1])
    at = flat[idx.long(), torch.arange(flat.shape[1], device=flat.device)]
    return (idx != best_idx) & (at < best_val - margin)


def hold_against_k1(name, ops, ph, pw, k1, val, idx):
    """K1's (values, indices) against another route's on the same operands:
    values within SCORE_ATOL, indices equal wherever the top-two margin
    exceeds MARGIN_ATOL. Returns (equal indices, max |difference|)."""
    err = float((k1[0] - val).abs().max())
    if err > SCORE_ATOL:
        raise AssertionError(f"{name}: K1's winning scores {err:.3g} from "
                             f"the other route's")
    bad = int(sk.index_disagreements(ops, ph, pw, k1[1], val, idx,
                                      MARGIN_ATOL).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} index disagreements beyond the "
                             f"{MARGIN_ATOL} margin")
    return int((k1[1] == idx).sum()), err


def routes_agree(name, tiled, mat):
    """The tiled search's results against the materialized route's on the
    same inputs: bit-equal winning scores mean equal indices; otherwise the
    indices must be equal wherever the map's top-two margin exceeds
    MARGIN_ATOL. Returns a sentence for the log."""
    bit_equal = all(torch.equal(t.best_score, m.best_score)
                    for t, m in zip(tiled, mat))
    equal = sum(int((t.best_flat == m.best_flat).sum())
                for t, m in zip(tiled, mat))
    total = sum(m.best_flat.numel() for m in mat)
    bad = sum(int(map_disagreements(m.score_map, t.best_flat, m.best_score,
                                    m.best_flat, MARGIN_ATOL).sum())
              for t, m in zip(tiled, mat))
    if bad or (bit_equal and equal != total):
        raise AssertionError(f"{name}: {total - equal} indices differ from "
                             f"the materialized route's ({bad} beyond the "
                             f"margin; scores bit-equal: {bit_equal})")
    return (f"indices equal {equal}/{total}, winning scores "
            + ("bit-equal" if bit_equal else
               f"within {max(float((t.best_score - m.best_score).abs().max()) for t, m in zip(tiled, mat)):.3g}")
            + " on the card")


def tiled_search_checks(seed: int, dev):
    """(a) the tiled search at 320x1224, batch 2, with the standard prior,
    against K1 and the materialized route, timed with its peak memory; (b)
    a custom prior under 'auto' takes the tiled route."""
    rng = np.random.default_rng(seed + 9)
    x = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    factors = sifinder_lib.gaussian_position_mask_factors(H, W, PH, PW)

    def tiled(mask=None, row_chunk=32):
        return [sifinder_lib.search_single_tiled(
            xt[i], yt[i], yt[i], PH, PW,
            mask_factors=None if mask is not None else factors, mask=mask,
            row_chunk=row_chunk) for i in range(2)]

    def materialized(mask=None):
        if mask is not None:
            return [sifinder_lib.search_single(xt[i], yt[i], yt[i], mask, PH,
                                               PW) for i in range(2)]
        return [sifinder_lib.search_single(
            xt[i], None, None, None, PH, PW, prep=sifinder_lib.build_side_prep(
                yt[i], yt[i], PH, PW, mask_factors=factors))
            for i in range(2)]

    got = tiled()
    ops = operands(x, y, True, dev)
    k1 = sk.pearson_argmax(*ops, PH, PW)
    equal, err = hold_against_k1(
        "tiled vs K1", ops, PH, PW, k1,
        torch.stack([r.best_score for r in got]),
        torch.stack([r.best_flat for r in got]))
    log(f"  (a) tiled search, batch 2, standard prior as factors, row chunk "
        f"32, vs K1: indices equal {equal}/{2 * ops[1].shape[1]} (the rest "
        f"within the {MARGIN_ATOL} margin), winning scores within {err:.3g}")
    mat = materialized()
    log("  (a) tiled vs the materialized torch route: "
        + routes_agree("tiled vs materialized", got, mat))
    del mat
    tiled_ms = cuda_ms(lambda: tiled(), 3)
    mat_ms = cuda_ms(lambda: materialized(), 2)
    _, tiled_peak = peak_above(lambda: [r.best_flat for r in tiled()])
    _, mat_peak = peak_above(lambda: [r.best_flat for r in materialized()])
    log(f"  (a) batch 2 at {H}x{W}: tiled {tiled_ms:.2f} ms, peak "
        f"{tiled_peak / 2**30:.3f} GiB above its inputs; materialized "
        f"{mat_ms:.2f} ms, peak {mat_peak / 2**30:.3f} GiB (CUDA events, "
        f"mean of 3 and 2 after a warm-up)")

    # (b) a custom prior: 'auto' on the card takes the tiled route
    ae, _ = full_configs()
    custom = torch.as_tensor(sifinder_lib.gaussian_position_mask(
        H, W, PH, PW) * 0.5 + 0.25, device=dev)
    sifinder_lib.reset_route_counts()
    sk.reset_launch_counts()
    y_syn = sifinder_lib.synthesize_side_image(xt, yt, yt, custom, PH, PW, ae)
    routes, launches = dict(sifinder_lib.route_counts), dict(sk.launch_counts)
    if routes != {"torch": 0, "tiled": 1, "kernel": 0} or any(
            launches.values()):
        raise AssertionError(f"a custom prior under 'auto': routes {routes}, "
                             f"launches {launches}")
    got = tiled(mask=custom, row_chunk=sifinder_lib.sifinder_row_chunk(ae))
    if not torch.equal(y_syn, torch.stack([r.y_syn for r in got])):
        raise AssertionError("'auto' with a custom prior differs from the "
                             "tiled search on it")
    log(f"  (b) custom prior (Gaussian x 0.5 + 0.25) under 'auto': routes "
        f"{routes}, no kernel launch; vs the materialized route: "
        + routes_agree("custom prior", got, materialized(custom)))


def scores_checks(seed: int, dev):
    """(c) `DeviceServer.decode_si(with_scores=True)`, 4 requests on one
    session: images bit-equal with the flag on and off on one route, the
    scores within SCORE_ATOL of K2's best values on the same requests."""
    rng = np.random.default_rng(seed + 10)
    ae, pc = full_configs()
    imgs = smooth_images(rng, 4, extra_w=64)
    x = np.clip(imgs[:, :, :W] + rng.normal(0, 4, (4, H, W, 3)),
                0, 255).astype(np.float32)
    y = imgs[0, :, 16:16 + W].copy()
    parts = []
    k2 = None
    for impl in ("auto", "torch", "tiled"):
        server = DeviceServer(ae.replace(sifinder_impl=impl), pc, device=dev,
                              seed=seed)
        prep = server.open_session(y)
        symbols, _ = server.encode(x)
        sifinder_lib.reset_route_counts()
        sk.reset_launch_counts()
        off = server.decode_si(symbols, prep)
        on, scores = server.decode_si(symbols, prep, with_scores=True)
        routes = dict(sifinder_lib.route_counts)
        if impl == "auto":
            if routes != {"torch": 1, "tiled": 0, "kernel": 1} or \
                    sk.launch_counts["pearson_argmax_shared"] != 1:
                raise AssertionError(f"'auto' with and without scores: "
                                     f"routes {routes}, {sk.launch_counts}")
            with torch.inference_mode():
                x_dec = server.model.decode(centers_lookup(
                    server.model.centers, symbols))
                k2 = sk.pearson_argmax_shared(
                    prep.y_t, sk.prepare_query(x_dec, PH, PW),
                    prep.inv_denom, prep.gh_k, prep.gw_t, PH, PW)
        elif not torch.equal(off, on):
            raise AssertionError(f"{impl}: decode_si differs with the scores "
                                 f"flag on")
        err = float((scores - k2[0]).abs().max())
        if tuple(scores.shape) != tuple(k2[0].shape) or err > SCORE_ATOL:
            raise AssertionError(f"{impl}: scores {tuple(scores.shape)} "
                                 f"{err:.3g} from K2's best values")
        parts.append(f"{impl} (route {'torch' if impl == 'auto' else impl}) "
                     f"within {err:.3g} of K2's")
    log("  (c) decode_si(with_scores=True), 4 requests on one session: "
        "images bit-equal with the flag off on the torch and tiled routes; "
        "scores " + "; ".join(parts))


def l2_checks(seed: int, dev):
    """(d) use_L2andLAB at the full width of ae_kitti_stereo, 320x1224: one
    forward at batch 2 and a session of 4 requests with no K1/K2 launch,
    then planted patches found exactly."""
    rng = np.random.default_rng(seed + 11)
    ae, pc = full_configs()
    ae = ae.replace(use_L2andLAB=True)
    model = build_model(ae, pc, device=dev, seed=seed)
    forward = make_forward(model, H, W)
    x = torch.from_numpy(rng.uniform(0, 255, (2, H, W, 3)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.uniform(0, 255, (2, H, W, 3)).astype(
        np.float32)).to(dev)
    forward(x, y)                                # warm-up
    sk.reset_launch_counts()
    sifinder_lib.reset_route_counts()
    (x_si, bpp), peak = peak_above(lambda: forward(x, y))
    fwd_ms = cuda_ms(lambda: forward(x, y), 2)
    check_image("L2 forward x_with_si", x_si, (2, H, W, 3), clipped=False)
    if not np.isfinite(float(bpp)):
        raise AssertionError("L2 forward bpp not finite")
    server = DeviceServer(ae, pc, device=dev, seed=seed)
    imgs = smooth_images(rng, 4, extra_w=64)
    xs = np.clip(imgs[:, :, :W] + rng.normal(0, 4, (4, H, W, 3)),
                 0, 255).astype(np.float32)
    prep = server.open_session(imgs[0, :, 16:16 + W].copy())
    symbols, _ = server.encode(xs)
    out = server.decode_si(symbols, prep)
    check_image("L2 decode_si", out, (4, H, W, 3), clipped=True)
    _, serve_peak = peak_above(lambda: server.decode_si(symbols, prep))
    serve_ms = cuda_ms(lambda: server.decode_si(symbols, prep), 2)
    launches, routes = dict(sk.launch_counts), dict(sifinder_lib.route_counts)
    if any(launches.values()) or routes["kernel"] or routes["tiled"]:
        raise AssertionError(f"L2 launched {launches}, routes {routes}")
    if prep.sum_y2 is None or prep.y_t is not None:
        raise AssertionError("the L2 session's prep is not an L2 prep")

    xp = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    yp = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    wc, gw_n = W - PW + 1, W // PW
    planted = {}
    for j, p in enumerate(rng.choice((H // PH) * gw_n, 40, replace=False)):
        r0, c0 = (j // 8) * (PH + 8) + 3, (j % 8) * (PW + 120) + 5
        pr, pc_ = (p // gw_n) * PH, (p % gw_n) * PW
        yp[r0:r0 + PH, c0:c0 + PW] = xp[pr:pr + PH, pc_:pc_ + PW]
        planted[int(p)] = r0 * wc + c0
    res = sifinder_lib.search_single(
        *(torch.from_numpy(a).to(dev) for a in (xp, yp, yp)), None, PH, PW,
        use_l2=True)
    missed = {p: int(res.best_flat[p]) for p, flat in planted.items()
              if int(res.best_flat[p]) != flat}
    if missed:
        raise AssertionError(f"L2: planted patches not found: {missed}")
    log(f"  (d) L2/LAB, ae_kitti_stereo at {H}x{W}: forward batch 2 "
        f"{fwd_ms:.2f} ms (CUDA events), peak {peak / 2**30:.2f} GiB, bpp "
        f"{float(bpp):.4f}; decode_si of 4 requests {serve_ms:.2f} ms, peak "
        f"{serve_peak / 2**30:.2f} GiB; outputs finite, decode_si in [0, "
        f"255]; routes {routes}, no K1/K2 launch; {len(planted)} planted "
        f"patches found exactly")


def cityscapes_checks(seed: int, dev):
    """(e) the Cityscapes geometry through `tools/cityscapes_chip.run`: one
    warm-up and CS_STEPS timed train steps at 1024x2048, then K1 on one
    decoded pair against the tiled search, timed beside its bound."""
    t0 = time.perf_counter()
    report, trained = cityscapes_chip.run(steps=CS_STEPS, device=dev,
                                          seed=seed)
    secs = time.perf_counter() - t0
    attempt = report["attempts"][-1]
    if not report["ok"] or attempt["unmoved_params"]:
        raise AssertionError(f"Cityscapes run: {json.dumps(report)[:2000]}")
    log(f"  (e) {report['config']} at {report['crop']}, batch 1, "
        f"{attempt['compute_dtype']}, remat: {len(report['attempts'])} "
        f"attempt(s), row chunk {attempt['sifinder_row_chunk']} fitted; "
        f"ms per step " + "/".join(f"{v:.1f}" for v in attempt["step_ms"])
        + ", the search inside each step " + "/".join(
            f"{v:.1f}" for v in attempt["search_ms"])
        + f" (CUDA events); first step {attempt['first_step_ms']:.0f} ms; "
        f"loss {attempt['first_loss']:.4f} -> {attempt['last_loss']:.4f}, "
        f"bpp {attempt['bpp']:.4f}; all {attempt['trained_params']} trained "
        f"parameters moved; peak {attempt['peak_bytes'] / 2**30:.2f} GiB; "
        f"{secs:.1f} s in all")
    for failed in report["attempts"][:-1]:
        log(f"    row chunk {failed['sifinder_row_chunk']}: "
            f"{failed['error'][:200]}")

    model, cfg = trained.model, trained.config
    ph, pw = (int(v) for v in cfg.y_patch_size)
    h, w = trained.x.shape[1:3]
    x_dec, y_dec = search_operands(model, trained.x, trained.y)
    del trained, model
    gh, gw = sifinder_lib.gaussian_position_mask_factors(h, w, ph, pw)
    y_t, inv = sk.side_from_transformed(color_lib.search_transform(y_dec[0]),
                                        ph, pw)
    ops = (y_t[None].contiguous(), sk.prepare_query(x_dec, ph, pw),
           inv[None].contiguous(), torch.from_numpy(gh).to(dev),
           torch.from_numpy(np.ascontiguousarray(gw.T)).to(dev))
    row_chunk = sifinder_lib.sifinder_row_chunk(cfg)

    def tiled():
        return sifinder_lib.search_single_tiled(
            x_dec[0], y_dec[0], y_dec[0], ph, pw, mask_factors=(gh, gw),
            row_chunk=row_chunk)

    ref = tiled()
    k1 = sk.pearson_argmax(*ops, ph, pw)
    p = ops[1].shape[1]
    equal, err = hold_against_k1("Cityscapes K1 vs tiled", ops, ph, pw, k1,
                                 ref.best_score[None], ref.best_flat[None])
    k1_ms = cuda_ms(lambda: sk.pearson_argmax(*ops, ph, pw), 2)
    plain_ms = cuda_ms(lambda: sk.pearson_argmax_reference(*ops, ph, pw), 1)
    tiled_ms = cuda_ms(tiled, 1)
    _, _, bnds = bound(ops, False)
    hc, wc = inv.shape
    tiles = -(-(hc * wc) // sk.load_library().position_tile)
    log(f"  (e) K1 at {h}x{w}, {ph}x{pw} patches (P = {p}, K = "
        f"{ops[1].shape[2]}, a {hc}x{wc} map, "
        f"{-(-tiles // sk.TILES_PER_GROUP)} position groups) on one decoded "
        f"pair vs the tiled search (row chunk "
        f"{row_chunk}): indices equal {equal}/{p} (the rest within the "
        f"{MARGIN_ATOL} margin), winning scores within {err:.3g}; K1 "
        f"{k1_ms:.2f} ms, {bound_text(bnds, k1_ms)}; its plain version "
        f"{plain_ms:.2f} ms; the tiled search {tiled_ms:.2f} ms (CUDA "
        f"events)")


def search_phase(seed: int, dev):
    tiled_search_checks(seed, dev)
    scores_checks(seed, dev)
    l2_checks(seed, dev)
    cityscapes_checks(seed, dev)


# -- phase 10: the compression service at full width ------------------------

SERVE_BUCKETS = ((160, 600), (320, 1224))
# 10 requests at the large bucket, 2 padded to it, 4 padded to the small one
SERVE_SHAPES = [(H, W)] * 10 + [(300, 1200)] * 2 + [(150, 590)] * 4
SERVE_CLIENTS = 4
SERVE_TIMEOUT_S = 600.0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def from_clients(submit, items):
    """From SERVE_CLIENTS client threads, each submitting its share of the
    items at once (`submit(item) -> Future`) and then waiting for them;
    -> (results, ms from submit to resolution per item, wall s)."""
    out, ms = [None] * len(items), [0.0] * len(items)

    def client(k):
        mine = range(k, len(items), SERVE_CLIENTS)
        futs = []
        for i in mine:
            t0 = time.perf_counter()
            fut = submit(items[i])
            fut.add_done_callback(
                lambda f, i=i, t0=t0: ms.__setitem__(
                    i, 1e3 * (time.perf_counter() - t0)))
            futs.append(fut)
        for i, fut in zip(mine, futs):
            out[i] = fut.result(SERVE_TIMEOUT_S)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
        for f in [pool.submit(client, k) for k in range(SERVE_CLIENTS)]:
            f.result()
    return out, ms, time.perf_counter() - t0


def hist_line(summary) -> str:
    return (f"n {summary['count']}, mean {summary['mean']:.2f}, p50 "
            f"{summary['p50']:.2f}, max {summary['max']:.2f}")


def lanes(svc, record, vols):
    """The padded symbol batch of a recorded decode batch: each lane's
    decoded volume, zeros in the padding and in a lane that failed."""
    _, (bh, bw), _, payloads, futs = record
    sym = np.zeros((svc.config.max_batch, bh // 8, bw // 8,
                    svc.server.config.num_chan_bn), np.int32)
    for i, (payload, fut) in enumerate(zip(payloads, futs)):
        if fut.exception(0) is None:
            sym[i] = vols[payload[0]].transpose(1, 2, 0)
    return sym


def device_images(svc, record, sym):
    """DeviceServer on one recorded batch, as the service crops and casts."""
    kind, _, session, _, _ = record
    server = svc.server
    if kind == "decode_si":
        out = server.decode_si(sym, svc._sessions.get(session).prep)
    else:
        out = server.decode(sym)
    return out.cpu().numpy()


def check_decode_records(svc, records, vols) -> int:
    """Every served decode / decode_si image bit-equal to DeviceServer on
    the batch the service formed, cropped and cast the same way."""
    checked = 0
    for record in records:
        if record[0] == "encode":
            continue
        imgs = device_images(svc, record, lanes(svc, record, vols))
        for i, (payload, fut) in enumerate(zip(record[3], record[4])):
            if fut.exception(0) is not None:
                continue
            h, w = payload[1]
            want = imgs[i][:h, :w].astype(np.uint8)
            if not np.array_equal(fut.result(0), want):
                raise AssertionError(f"{record[0]} lane {i} of a batch "
                                     f"differs from DeviceServer")
            checked += 1
    return checked


def check_streams(svc, records):
    """Every DSRV frame parses and its payload is byte-equal to
    BottleneckCodec.encode_batch of DeviceServer's symbols for the same
    padded batch; every payload decodes to exactly those symbols.
    Returns {payload: volume}."""
    from dsin_tpu_torch.serve.service import parse_stream
    vols, n = {}, 0
    for kind, bucket, _, payloads, futs in records:
        if kind != "encode":
            continue
        x = np.zeros((svc.config.max_batch, *bucket, 3), np.float32)
        for i, payload in enumerate(payloads):
            x[i] = payload[0]                  # the padded request
        sym = svc.server.encode_symbols(x).cpu().numpy()
        want = svc.codec.encode_batch(
            [np.transpose(sym[i], (2, 0, 1)) for i in range(len(futs))])
        for i, fut in enumerate(futs):
            res = fut.result(0)
            payload, shape, got_bucket = parse_stream(res.stream)
            if payload != want[i] or shape != payloads[i][1] \
                    or got_bucket != bucket:
                raise AssertionError(f"encode lane {i}: the stream is not "
                                     f"the codec's stream of DeviceServer's "
                                     f"symbols")
            back = svc.codec.decode(payload)
            if not np.array_equal(back, np.transpose(sym[i], (2, 0, 1))):
                raise AssertionError(f"encode lane {i}: the payload does "
                                     f"not decode to its symbols")
            vols[payload] = back
            n += 1
    return vols, n


def k2_on_a_service_batch(svc, record, vols):
    """K2 against its plain version on the operands of one SI batch the
    service formed: the decoded batch's query patches and the session's
    cached side operands."""
    prep = svc._sessions.get(record[2]).prep
    sym = torch.as_tensor(lanes(svc, record, vols), device=prep.y_t.device)
    model = svc.server.model
    with torch.inference_mode():
        x_dec = model.decode(centers_lookup(model.centers, sym))
        pk_ = sk.prepare_query(x_dec, PH, PW)
    b = pk_.shape[0]
    shared = (prep.y_t, pk_, prep.inv_denom, prep.gh_k, prep.gw_t)
    batched = (prep.y_t.expand(b, *prep.y_t.shape), pk_,
               prep.inv_denom.expand(b, *prep.inv_denom.shape), prep.gh_k,
               prep.gw_t)
    return check_agreement("pearson_argmax_shared on a service SI batch",
                           batched, sk.pearson_argmax_shared(*shared, PH, PW),
                           sk.pearson_argmax_reference(*batched, PH, PW))


def batchmates(svc, records, vols):
    """Is a request's image the same decoded alone (lane 0 of a padded
    batch) and inside a full batch of 4 of the bucket's served volumes?
    Printed, not a gate."""
    for kind in ("decode", "decode_si"):
        record = next(r for r in records if r[0] == kind)
        (bh, bw), full = record[1], lanes(svc, record, vols)
        same = [v for v in vols.values()
                if (v.shape[1] * 8, v.shape[2] * 8) == (bh, bw)]
        for i, v in enumerate(same[:len(full)]):
            full[i] = v.transpose(1, 2, 0)
        alone = np.zeros_like(full)
        alone[0] = full[0]
        a = device_images(svc, record, alone)[0]
        b = device_images(svc, record, full)[0]
        log(f"  batchmates, {kind} at {bh}x{bw}: lane 0 alone vs in a batch "
            f"of {min(len(same), len(full))} requests: "
            f"{'bit-equal' if np.array_equal(a, b) else 'DIFFERENT'} (max "
            f"|diff| {float(np.abs(a - b).max()):.3g})")


def typed_error_checks(svc, small_streams, records):
    """A flipped byte is refused at the door; a payload corrupted past the
    door (the serve.rans fault site) fails its own future with
    IntegrityError while its batchmates are served; an unknown session id
    raises SessionExpired."""
    from dsin_tpu_torch.serve import IntegrityError, SessionExpired
    from dsin_tpu_torch.utils import faults
    bad = bytearray(small_streams[0])
    bad[-1] ^= 0x01
    try:
        svc.submit_decode(bytes(bad))
        raise AssertionError("a flipped byte passed the door")
    except IntegrityError:
        pass
    try:
        svc.submit_decode_si(small_streams[0], "sess-unknown")
        raise AssertionError("an unknown session id passed the door")
    except SessionExpired:
        pass
    n0 = len(records)
    plan = faults.FaultPlan([faults.FaultSpec("serve.rans", "corrupt",
                                              after=1, times=1)])
    with faults.installed(plan):
        futs = [svc.submit_decode(s) for s in small_streams]
        errors = [f.exception(SERVE_TIMEOUT_S) for f in futs]
    bad_lanes = [e for e in errors if e is not None]
    if len(bad_lanes) != 1 or not isinstance(bad_lanes[0], IntegrityError):
        raise AssertionError(f"corrupted lane: {errors}")
    log(f"  typed errors: flipped byte refused at the door "
        f"(IntegrityError), unknown session (SessionExpired), a payload "
        f"corrupted in the worker failed its own future (IntegrityError) "
        f"while {len(futs) - 1} batchmates were served in "
        f"{len(records) - n0} batch(es)")
    return records[n0:], futs


def serve_traffic(seed: int):
    """Phase 10's traffic from `seed`: 2 smooth stereo-like side images and
    the 16 images to encode (SERVE_SHAPES), each owned by one side."""
    rng = np.random.default_rng(seed + 10)
    base = smooth_images(rng, 2, extra_w=64)
    sides = [np.clip(base[k, :, 16:16 + W], 0, 255).astype(np.uint8)
             for k in range(2)]
    imgs, owner = [], []
    for i, (h, w) in enumerate(SERVE_SHAPES):
        k = i % 2
        noisy = base[k, :, :W] + rng.normal(0, 4, (H, W, 3))
        imgs.append(np.clip(noisy[:h, :w], 0, 255).astype(np.uint8))
        owner.append(k)
    return sides, imgs, owner


def serve_config(seed: int, dev, **over):
    from dsin_tpu_torch.serve import ServiceConfig
    kw = dict(ae_config=config_path("ae_kitti_stereo"),
              pc_config=config_path("pc_default"), seed=seed,
              buckets=SERVE_BUCKETS, max_batch=4, max_wait_ms=5.0,
              entropy_workers=4, pipeline_depth=2, enable_si=True,
              device=str(dev))
    kw.update(over)
    return ServiceConfig(**kw)


def drive(svc, traffic) -> dict:
    """Open the 2 sessions, then from SERVE_CLIENTS clients encode every
    image and decode every stream (decode_si against its session at the
    large bucket, decode at the small one), recording each batch the
    service forms (its batch hook) and K1/K2's launches in the traffic."""
    sides, imgs, owner = traffic
    sids, open_ms = [], []
    for side in sides:
        t0 = time.perf_counter()
        sids.append(svc.open_session(side))
        open_ms.append(1e3 * (time.perf_counter() - t0))
    records = []
    svc._batch_hook = lambda batch: records.append((
        batch[0].key[0], batch[0].key[1], batch[0].session,
        [r.payload for r in batch], [r.future for r in batch]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    builds = native_build.build_count()
    sk.reset_launch_counts()
    enc, enc_ms, enc_s = from_clients(svc.submit_encode, imgs)
    big = SERVE_BUCKETS[-1]
    jobs = [(r.stream, sids[k] if r.bucket == big else None)
            for r, k in zip(enc, owner)]
    dec, dec_ms, dec_s = from_clients(
        lambda job: (svc.submit_decode_si(*job) if job[1] is not None
                     else svc.submit_decode(job[0])), jobs)
    torch.cuda.synchronize()
    launches = dict(sk.launch_counts)
    svc._batch_hook = None
    if native_build.build_count() != builds:
        raise AssertionError("serving built a native library after warmup")
    si_batches = sum(r[0] == "decode_si" for r in records)
    if launches != {"pearson_argmax": 0,
                    "pearson_argmax_shared": si_batches}:
        raise AssertionError(f"launches {launches}, SI batches "
                             f"{si_batches}")
    for img, out in zip(imgs, dec):
        if out.shape != img.shape or out.dtype != np.uint8:
            raise AssertionError(f"decoded {out.shape} {out.dtype} for "
                                 f"{img.shape}")
    return dict(enc=enc, enc_ms=enc_ms, enc_s=enc_s, dec=dec, dec_ms=dec_ms,
                dec_s=dec_s, jobs=jobs, records=records, open_ms=open_ms,
                launches=launches, si_batches=si_batches,
                peak=torch.cuda.max_memory_allocated() / 2**30)


def host_cores() -> str:
    return (f"host cores {os.cpu_count()} (affinity "
            f"{len(os.sched_getaffinity(0))})")


def report_run(svc, run, label: str, warm_s: float) -> None:
    """Per-run numbers: submit -> result median and max per kind, the
    per-kind device / entropy histograms, overlap, requests/s, warmup s,
    shm lane traffic, the host's cores and the card."""
    snap = svc.metrics.snapshot()
    hists, counters = snap["histograms"], snap["counters"]
    kinds = {"encode": run["enc_ms"],
             "decode": [m for m, j in zip(run["dec_ms"], run["jobs"])
                        if j[1] is None],
             "decode_si": [m for m, j in zip(run["dec_ms"], run["jobs"])
                           if j[1] is not None]}
    for kind, ms in kinds.items():
        log(f"  {label} {kind}: {len(ms)} requests, submit -> result ms "
            f"median {float(np.median(ms)):.1f}, max {max(ms):.1f}; "
            f"serve_device_ms_{kind} "
            f"{hist_line(hists[f'serve_device_ms_{kind}'])}; "
            f"serve_entropy_ms_{kind} "
            f"{hist_line(hists[f'serve_entropy_ms_{kind}'])}")
    n_req = len(run["enc"]) + len(run["jobs"])
    wall = run["enc_s"] + run["dec_s"]
    shm = {k: counters.get(f"serve_shm_{k}", 0)
           for k in ("sends", "bytes", "fallbacks")}
    log(f"  {label}: serve_overlap_ratio "
        f"{snap['gauges']['serve_overlap_ratio']:.3f}, {n_req} requests in "
        f"{wall:.2f} s = {n_req / wall:.2f} requests/s (encode "
        f"{len(run['enc']) / run['enc_s']:.2f}/s, decode "
        f"{len(run['jobs']) / run['dec_s']:.2f}/s), {len(run['records'])} "
        f"batches, warmup {warm_s:.2f} s, shm sends {shm['sends']} "
        f"({shm['bytes']} B), fallbacks {shm['fallbacks']}, peak device "
        f"memory {run['peak']:.2f} GiB, {host_cores()}, card {card_line()}")


def drain_checked(svc, futures, label: str) -> None:
    drained = svc.drain(timeout=SERVE_TIMEOUT_S)
    hung = sum(not f.done() for f in futures)
    if not drained or hung:
        raise AssertionError(f"{label} drain: {drained}, {hung} unresolved "
                             f"futures")
    log(f"  {label}: drain() True, {len(futures)} futures all resolved")


def thread_run(seed: int, dev, traffic):
    """Run A, the thread backend: the traffic with every check against
    DeviceServer and the codec; -> (K2 launches, streams, images)."""
    from urllib.request import urlopen
    from dsin_tpu_torch.serve import CompressionService
    svc = CompressionService(serve_config(seed, dev,
                                          metrics_port=0)).start()
    futures = []
    try:
        warm = svc.warmup()
        log(f"  A (thread): start + warmup: {warm['seconds']:.2f} s warmup, "
            f"{warm['builds']} native builds in it")
        run = drive(svc, traffic)
        records, launches = run["records"], run["launches"]
        for r in records:
            futures += r[4]
        vols, n_streams = check_streams(svc, records)
        n_images = check_decode_records(svc, records, vols)
        si_record = next(r for r in records if r[0] == "decode_si")
        err = k2_on_a_service_batch(svc, si_record, vols)
        log(f"  {n_streams} streams byte-equal to BottleneckCodec."
            f"encode_batch of DeviceServer's symbols, exact round trips; "
            f"{n_images} images bit-equal to DeviceServer on the recorded "
            f"batches; K2 {launches['pearson_argmax_shared']} launches = "
            f"{run['si_batches']} SI batches, K1 0; K2 on a service batch "
            f"vs plain max |val - plain| {err:.3g}; no native build after "
            f"warmup")
        batchmates(svc, records, vols)
        big = SERVE_BUCKETS[-1]
        err_records, err_futs = typed_error_checks(
            svc, [r.stream for r in run["enc"] if r.bucket != big], records)
        futures += err_futs
        check_decode_records(svc, err_records, vols)
        port = svc.metrics_port
        for path in ("/healthz", "/metrics"):
            with urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
                if r.status != 200 or not r.read():
                    raise AssertionError(f"{path} answered {r.status}")
        log(f"  /healthz and /metrics answer on port {port}")
        hists = svc.metrics.snapshot()["histograms"]
        log(f"  open_session ms "
            f"{', '.join(f'{t:.2f}' for t in run['open_ms'])} "
            f"(serve_si_prep_ms {hist_line(hists['serve_si_prep_ms'])})")
        report_run(svc, run, "A (thread, 4 entropy threads, depth 2)",
                   warm["seconds"])
    finally:
        drain_checked(svc, futures, "A")
    return (launches["pearson_argmax_shared"],
            [r.stream for r in run["enc"]], run["dec"])


def check_children(pings, label: str) -> None:
    """No child initialised CUDA or built a native library, and none
    imported a module the parent does not hold (the parent, this script,
    imports nothing of JAX: tests/test_torch_package.py)."""
    parent = {m.split(".")[0] for m in sys.modules}
    for p in pings:
        extra = sorted(set(p["top_modules"]) - parent)
        if p["cuda_initialized"] or p["native_builds"] or extra:
            raise AssertionError(f"{label}: entropy child {p['pid']}: CUDA "
                                 f"{p['cuda_initialized']}, native builds "
                                 f"{p['native_builds']}, modules the parent "
                                 f"does not hold {extra}")


def check_against_a(run, ref, label: str) -> list:
    """Every encode stream byte-equal and every image bit-equal to run A's;
    -> the run's streams."""
    ref_streams, ref_images = ref
    streams = [r.stream for r in run["enc"]]
    if streams != ref_streams:
        bad = [i for i, (a, b) in enumerate(zip(streams, ref_streams))
               if a != b]
        raise AssertionError(f"{label}: streams {bad} differ from run A's")
    bad = [i for i, (a, b) in enumerate(zip(run["dec"], ref_images))
           if not np.array_equal(a, b)]
    if bad:
        raise AssertionError(f"{label}: images {bad} differ from run A's")
    return streams


def process_run(seed: int, dev, traffic, ref, label: str, transport: str,
                depth: int, kill: bool = False) -> int:
    """One run of the process entropy backend (4 children) on the same
    traffic: every stream byte-equal and every image bit-equal to run A's,
    K2 once per SI batch, no native build after warmup in the parent or any
    child, no CUDA context and no jax in a child, lane traffic on shm, no
    pool rebuild. With `kill`, after the traffic one child is SIGKILLed and
    the next encode must rebuild the pool once and give run A's bytes.
    Returns K2's launches in the traffic."""
    import pickle
    import signal
    from dsin_tpu_torch.serve import CompressionService
    ref_streams = ref[0]
    svc = CompressionService(serve_config(
        seed, dev, entropy_backend="process", transport=transport,
        pipeline_depth=depth)).start()
    futures = []
    try:
        wall0 = time.time()
        warm = svc.warmup()
        pings = svc._proc_warm
        check_children(pings, label)
        initargs = svc._swap.current.proc_initargs
        log(f"  {label}: the pool initializer's arguments pickle to "
            f"{len(pickle.dumps(initargs))} B (the codec spec rides a "
            f"{os.path.getsize(initargs[0])} B file)")
        log(f"  {label}: start + warmup {warm['seconds']:.2f} s (4 children "
            f"spawned, codec rebuilt and schedules "
            f"{sorted({tuple(s) for p in pings for s in p['schedules']})} "
            f"warmed in each), {warm['builds']} native builds in it; "
            f"children {sorted(p['pid'] for p in pings)}, CUDA initialised "
            f"in none, torch threads "
            f"{sorted({p['torch_threads'] for p in pings})}, OpenBLAS "
            f"threads {sorted({t for p in pings for t in p['blas_threads']})}"
            f"; the children's initializers started "
            f"{min(p['init_wall'] for p in pings) - wall0:.2f}-"
            f"{max(p['init_wall'] for p in pings) - wall0:.2f} s into the "
            f"warmup and took {min(p['init_s'] for p in pings):.2f}-"
            f"{max(p['init_s'] for p in pings):.2f} s")
        run = drive(svc, traffic)
        for r in run["records"]:
            futures += r[4]
        streams = check_against_a(run, ref, label)
        after = svc._ping_children(svc._swap.current)
        check_children(after, label)
        counters = svc.metrics.snapshot()["counters"]
        if counters.get("serve_entropy_proc_rebuilds", 0) != 0:
            raise AssertionError(f"{label}: the pool was rebuilt during the "
                                 f"traffic")
        if transport == "shm" and counters.get("serve_shm_sends", 0) <= 0:
            raise AssertionError(f"{label}: no shm lane send")
        log(f"  {label}: {len(streams)} streams byte-equal and "
            f"{len(run['dec'])} images bit-equal to run A's; K2 "
            f"{run['launches']['pearson_argmax_shared']} launches = "
            f"{run['si_batches']} SI batches, K1 0; no native build after "
            f"warmup in the parent or the {len(after)} children, none "
            f"initialised CUDA or imported a module the parent does not "
            f"hold; 0 pool rebuilds")
        report_run(svc, run, label, warm["seconds"])
        if kill:
            victim = pings[0]["pid"]
            os.kill(victim, signal.SIGKILL)
            t0 = time.perf_counter()
            again = svc.encode(traffic[1][0], timeout=SERVE_TIMEOUT_S)
            rebuilds = svc.metrics.counter(
                "serve_entropy_proc_rebuilds").value
            if again.stream != ref_streams[0] or rebuilds != 1:
                raise AssertionError(f"{label}: after SIGKILL of child "
                                     f"{victim}: rebuilds {rebuilds}, bytes "
                                     f"equal {again.stream == ref_streams[0]}")
            log(f"  {label}: SIGKILL of child {victim}: the next encode "
                f"rebuilt the pool once and returned run A's bytes in "
                f"{1e3 * (time.perf_counter() - t0):.1f} ms (spawn and "
                f"codec warm included)")
    finally:
        drain_checked(svc, futures, label)
    return run["launches"]["pearson_argmax_shared"]


def service_phase(seed: int, dev) -> int:
    """Phase 10: run A (thread backend) with every check, then run C of the
    process backend (shm at depth 4, the SIGKILL rebuild) on the same
    traffic; returns K2's launches summed over the runs' traffic."""
    traffic = serve_traffic(seed)
    k2, streams, images = thread_run(seed, dev, traffic)
    return k2 + process_run(seed, dev, traffic, (streams, images),
                            "C (process, shm, depth 4)", "shm", 4, kill=True)


# -- phase 11: the model lifecycle on one card -------------------------------

LIFE_SEEDS = {"A": 101, "B": 102}     # added to --seed
LIFE_LOAD_S = 4.0            # traffic before the prepare and after the commit
LIFE_CANARY_EVERY_S = 1.0
LIFE_SESSIONS = 8
LIFE_REOPENS = 3             # re-opens of a session a commit expired


def child_pids() -> list:
    """Every child process of this one (zombies included: an unreaped child
    counts), read from /proc, less multiprocessing's resource tracker (one
    for the process's life, started with the first pool)."""
    from multiprocessing import resource_tracker
    tracker = getattr(resource_tracker._resource_tracker, "_pid", None)
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if ppid == me and int(d) != tracker:
            out.append(int(d))
    return sorted(out)


def shm_segments() -> list:
    return sorted(n for n in os.listdir("/dev/shm")
                  if n.startswith("dsintorch-"))


def life_checkpoints(seed: int, root: str) -> dict:
    """Checkpoints A and B: the full-width model from two seeds, saved with
    the manifest a service verifies (pc-config hash, seed, bucket ladder);
    name -> (dir, ModelState, manifest extra)."""
    from dsin_tpu_torch.config import parse_config_file
    ae = parse_config_file(config_path("ae_kitti_stereo")).replace(
        AE_only=False)
    pc = parse_config_file(config_path("pc_default"))
    out = {}
    for name, off in LIFE_SEEDS.items():
        state = ckpt_lib.state_from_model(
            build_model(ae, pc, device="cpu", seed=seed + off))
        extra = {"pc_config_sha256": ckpt_lib.config_sha256(pc),
                 "seed": seed + off,
                 "buckets": [list(b) for b in SERVE_BUCKETS]}
        path = os.path.join(root, name)
        ckpt_lib.save_checkpoint(path, state, manifest_extra=extra)
        out[name] = (path, state, extra)
    return out


def streams_alone(svc, bundle, imgs) -> list:
    """Each image's stream from `bundle` as the dataplane codes a request
    alone in its batch: lane 0 of a max_batch batch padded with zeros."""
    from dsin_tpu_torch.serve.buckets import pad_to_bucket
    from dsin_tpu_torch.serve.service import frame_stream
    out = []
    for img in imgs:
        h, w = img.shape[:2]
        bucket = svc.policy.bucket_for(h, w)
        x = np.zeros((svc.config.max_batch, *bucket, 3), np.float32)
        x[0] = pad_to_bucket(img.astype(np.float32), bucket)
        sym = bundle.server.encode_symbols(x).cpu().numpy()
        out.append(frame_stream(
            bundle.codec.encode(np.transpose(sym[0], (2, 0, 1))), (h, w),
            bucket))
    return out


class LifeLoad:
    """Phase 10's traffic on a loop from SERVE_CLIENTS client threads: each
    client encodes its images in turn and decodes each stream (decode_si
    against its owner's session at the large bucket, decode at the small
    one). A session that a commit or rollback expired answers typed
    SessionExpired: the client re-opens it and retries. Every request
    is recorded as (kind, image, submit s, resolve s, result, error)."""

    def __init__(self, svc, traffic):
        import threading
        self.svc, self.traffic = svc, traffic
        self.stop = threading.Event()
        self._lock = threading.Lock()
        self.records = []              # guarded-by: self._lock
        self.sids = {}                 # guarded-by: self._lock
        self.session_gone = 0          # guarded-by: self._lock
        self.threads = [threading.Thread(target=self._client, args=(c,),
                                         name=f"life-client-{c}")
                        for c in range(SERVE_CLIENTS)]

    def _sid(self, k: int, stale=None) -> str:
        with self._lock:
            if stale is not None and self.sids.get(k) == stale:
                del self.sids[k]
                self.session_gone += 1
            sid = self.sids.get(k)
        if sid is None:
            opened = self.svc.open_session(self.traffic[0][k])
            with self._lock:
                sid = self.sids.setdefault(k, opened)
            if sid != opened:      # another client re-opened it first
                self.svc.close_session(opened)
        return sid

    def _note(self, kind, i, t0, result=None, error=None) -> None:
        with self._lock:
            self.records.append((kind, i, t0, time.perf_counter(), result,
                                 error))

    def _decode_si(self, stream, k):
        """A session opened before the commit (or while it landed: its prep
        built on the old model) answers SessionExpired; re-open and retry,
        at most LIFE_REOPENS times."""
        from dsin_tpu_torch.serve import SessionExpired
        sid = self._sid(k)
        for _ in range(LIFE_REOPENS):
            try:
                return self.svc.decode_si(stream, sid,
                                          timeout=SERVE_TIMEOUT_S)
            except SessionExpired:
                sid = self._sid(k, stale=sid)
        return self.svc.decode_si(stream, sid, timeout=SERVE_TIMEOUT_S)

    def _client(self, c: int) -> None:
        _, imgs, owner = self.traffic
        big = SERVE_BUCKETS[-1]
        while not self.stop.is_set():
            for i in range(c, len(imgs), SERVE_CLIENTS):
                for kind in ("encode", "decode"):
                    t0 = time.perf_counter()
                    try:
                        if kind == "encode":
                            res = self.svc.encode(imgs[i],
                                                  timeout=SERVE_TIMEOUT_S)
                            stream = res.stream
                        elif self.svc.policy.bucket_for(
                                *imgs[i].shape[:2]) == big:
                            kind = "decode_si"
                            res = self._decode_si(stream, owner[i])
                        else:
                            res = self.svc.decode(stream,
                                                  timeout=SERVE_TIMEOUT_S)
                    except Exception as e:  # noqa: BLE001 — every failure
                        self._note(kind, i, t0, error=e)   # is a finding
                        break
                    self._note(kind, i, t0, result=res)

    def start(self) -> "LifeLoad":
        for t in self.threads:
            t.start()
        return self

    def finish(self) -> list:
        self.stop.set()
        for t in self.threads:
            t.join(SERVE_TIMEOUT_S)
        if any(t.is_alive() for t in self.threads):
            raise AssertionError("a load client did not finish")
        return self.records


def rate(records, t0: float, t1: float) -> float:
    done = sum(t0 <= r[3] < t1 for r in records)
    return done / (t1 - t0) if t1 > t0 else 0.0


def hold_canary(svc):
    """Claim the canary (waiting out a probe in flight), so no probe runs
    while launches are counted; the caller releases it."""
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    while not svc._canary.claim():
        if time.monotonic() > deadline:
            raise AssertionError("the canary prober never let go")
        time.sleep(0.01)


def check_still_a(svc, digest_a: str, a_streams, imgs, label: str) -> None:
    snap = svc.health()["model"]
    if snap["digest"] != digest_a or snap["swap_state"] != 0 \
            or snap["staged_digest"] is not None:
        raise AssertionError(f"{label}: not serving A, idle: {snap}")
    got = svc.encode(imgs[0], timeout=SERVE_TIMEOUT_S)
    if got.stream != a_streams[0] or got.model_digest != digest_a:
        raise AssertionError(f"{label}: A's bytes lost")


def lifecycle_phase(seed: int, dev, ckpts=None) -> int:
    """Phase 11 (see the module docstring); returns K2's launches in the
    swap-under-load traffic. `ckpts`: `life_checkpoints`' A and B, written
    here when not given."""
    from dsin_tpu_torch.serve import CanaryFailed, CompressionService
    from dsin_tpu_torch.tools.chaos_bench import bitflip_params
    from dsin_tpu_torch.utils import faults
    card = card_line()
    root = tempfile.mkdtemp(prefix="chip_smoke_life_")
    if ckpts is None:
        ckpts = life_checkpoints(seed, root)
    path_a, _, _ = ckpts["A"]
    path_b, state_b, extra_b = ckpts["B"]
    children0, shm0 = child_pids(), shm_segments()
    svc = CompressionService(serve_config(
        seed, dev, ckpt=path_a, entropy_backend="process", transport="pipe",
        session_max=LIFE_SESSIONS, canary_every_s=LIFE_CANARY_EVERY_S,
        rollback_watchdog_window_s=2.0)).start()
    traffic = serve_traffic(seed)
    imgs = traffic[1]
    k2 = 0
    try:
        warm = svc.warmup()
        builds = native_build.build_count()
        digest_a = svc.model_digest
        a_streams = streams_alone(svc, svc._swap.current, imgs)
        if svc.encode(imgs[0], timeout=SERVE_TIMEOUT_S).stream \
                != a_streams[0]:
            raise AssertionError("the service's stream is not A's alone")
        children1 = child_pids()
        log(f"  A from {path_a}: digest {digest_a}, warmup "
            f"{warm['seconds']:.2f} s, {len(children1) - len(children0)} "
            f"children, K2 route {svc._si_route!r} with scores "
            f"{'on' if svc._si_scores_enabled else 'off'} and quality on; "
            f"card {card}")

        # 1: the publish flow for B
        info = svc.prepare_swap(path_b)
        staged = svc._swap.staged
        b_streams = streams_alone(svc, staged, imgs)
        goldens = svc.canary_goldens(staged=True)
        during = len(child_pids())
        svc.abort_swap()
        left = sorted(set(child_pids()) - set(children1))
        if left or child_pids() != children1 or shm_segments() != shm0:
            raise AssertionError(f"abort left children {left} or segments "
                                 f"{shm_segments()}")
        path_b1 = os.path.join(root, "B1")
        ckpt_lib.save_checkpoint(path_b1, state_b,
                                 manifest_extra={**extra_b, "canary": goldens})
        sp = info["split"]
        log(f"  1 publish flow: prepare_swap(B) {info['seconds']:.2f} s "
            f"(load {sp['load_s']:.2f}, warm {sp['warm_s']:.2f}, pool start "
            f"{sp['pool_s']:.2f}; canary {info['canary']['status']}), "
            f"canary_goldens(staged=True), abort_swap: children "
            f"{len(children1)} -> {during} -> {len(child_pids())}, "
            f"dsintorch segments {len(shm0)} -> {len(shm_segments())}; "
            f"B' re-saved with goldens; card {card}")

        # 2: the swap under load
        records = []
        hold_canary(svc)
        svc._batch_hook = lambda batch: records.append(
            (batch[0].key[0], [r.future for r in batch]))
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        svc._canary.release()
        load = LifeLoad(svc, traffic).start()
        t_start = time.perf_counter()
        time.sleep(LIFE_LOAD_S)
        t_prep = time.perf_counter()
        info = svc.prepare_swap(path_b1)
        t_commit = time.perf_counter()
        snap = svc.commit_swap(expect_digest=info["digest"])
        t_done = time.perf_counter()
        digest_b = snap["digest"]
        time.sleep(LIFE_LOAD_S)
        done = load.finish()
        t_end = time.perf_counter()
        hold_canary(svc)
        torch.cuda.synchronize()
        svc._batch_hook = None
        launches = dict(sk.launch_counts)
        svc._canary.release()
        for _, futs in records:
            for f in futs:
                f.exception(SERVE_TIMEOUT_S)
        si_batches = sum(kind == "decode_si" and any(
            f.exception(0) is None for f in futs) for kind, futs in records)
        probes = 2 * len(SERVE_BUCKETS)   # the warm and the canary check
        if launches != {"pearson_argmax": 0,
                        "pearson_argmax_shared": si_batches + probes}:
            raise AssertionError(f"launches {launches}: {si_batches} SI "
                                 f"batches + {probes} warm and probe")
        k2 = launches["pearson_argmax_shared"]
        failed = [r for r in done if r[5] is not None]
        if failed:
            raise AssertionError(f"{len(failed)} requests failed under the "
                                 f"swap: {[repr(r[5]) for r in failed[:4]]}")
        old = new = 0
        for kind, i, t0, _, res, _ in done:
            if kind != "encode":
                if res.shape != imgs[i].shape or res.dtype != np.uint8:
                    raise AssertionError(f"{kind} gave {res.shape}")
                continue
            if res.model_digest == digest_a and res.stream == a_streams[i] \
                    and t0 < t_done:
                old += 1
            elif res.model_digest == digest_b and res.stream == b_streams[i]:
                new += 1
            else:
                raise AssertionError(f"encode of image {i} (submitted "
                                     f"{t0 - t_done:+.3f} s from the commit's "
                                     f"end) is neither A's stream nor B''s")
        if new == 0 or old == 0:
            raise AssertionError(f"{old} A and {new} B' streams: the swap "
                                 f"did not land mid-stream")
        sp = info["split"]
        log(f"  2 swap under load: {len(done)} requests ({old} A streams, "
            f"{new} B' streams, each byte-equal to its model's stream alone; "
            f"none failed; {load.session_gone} sessions re-opened after a "
            f"typed SessionExpired); prepare_swap(B') {info['seconds']:.2f} s "
            f"(load {sp['load_s']:.2f}, warm {sp['warm_s']:.2f}, pool start "
            f"{sp['pool_s']:.2f}, canary {sp['canary_s']:.2f}: "
            f"{info['canary']['status']}), commit "
            f"{1e3 * (t_done - t_commit):.2f} ms; requests/s before "
            f"{rate(done, t_start, t_prep):.2f}, during the prepare "
            f"{rate(done, t_prep, t_commit):.2f}, after the commit "
            f"{rate(done, t_done, t_end):.2f}; K2 {k2} launches = "
            f"{si_batches} SI batches + {probes} warm and canary; card {card}")

        # 3: rollback
        t0 = time.perf_counter()
        svc.rollback()
        roll_ms = 1e3 * (time.perf_counter() - t0)
        check_still_a(svc, digest_a, a_streams, imgs, "rollback")
        if streams_alone(svc, svc._swap.current, imgs) != a_streams:
            raise AssertionError("rollback: A's streams changed")
        probe = {"status": "busy"}
        while probe["status"] == "busy":
            probe = svc.run_canary()
        if probe["status"] != "ok":
            raise AssertionError(f"canary on A after the rollback: {probe}")
        log(f"  3 rollback {roll_ms:.2f} ms: serving A ({digest_a}), its "
            f"streams again; canary probe through the serve path "
            f"{probe['ms']:.1f} ms, per bucket {probe['bucket_ms']} ms "
            f"({probe['baseline']}); card {card}")

        # 4: the bit-flipped twin refused by the canary
        path_b2 = os.path.join(root, "B2")
        ckpt_lib.save_checkpoint(path_b2, bitflip_params(state_b),
                                 manifest_extra={**extra_b, "canary": goldens})
        try:
            svc.prepare_swap(path_b2)
            raise AssertionError("B'' was staged")
        except CanaryFailed as e:
            refusal = str(e)[:80]
        if svc._swap.staged is not None:
            raise AssertionError("B'' stays staged")
        check_still_a(svc, digest_a, a_streams, imgs, "canary refusal")
        log(f"  4 prepare_swap(B''): CanaryFailed ({refusal}...), nothing "
            f"staged, A serving its bytes; card {card}")

        # 5: the forced commit rolled back by the watchdog
        wd0 = svc.metrics.counter("serve_watchdog_rollbacks").value
        if svc._swap.snapshot()["prev_digest"] != digest_b:
            raise AssertionError("B' is not the bundle kept for rollback")
        t0 = time.perf_counter()
        forced = svc.swap_model(path_b2, canary=False)
        t_forced = time.perf_counter()
        while svc.model_digest != digest_a:
            if time.perf_counter() - t_forced > 120.0:
                raise AssertionError("the watchdog did not roll B'' back")
            time.sleep(0.01)
        t_back = time.perf_counter()
        # the watchdog counts its rollback once rollback() has returned,
        # just after the pointer swap this loop sees: wait for that count
        while (svc.metrics.counter("serve_watchdog_rollbacks").value == wd0
               and time.perf_counter() - t_back < 10.0):
            time.sleep(0.01)
        rollbacks = svc.metrics.counter("serve_watchdog_rollbacks").value
        failures = svc.metrics.counter("serve_canary_failures").value
        if rollbacks != wd0 + 1 or failures < 1:
            raise AssertionError(f"the rollback was not the watchdog's: "
                                 f"watchdog rollbacks {wd0} -> {rollbacks}, "
                                 f"canary failures {failures}")
        check_still_a(svc, digest_a, a_streams, imgs, "watchdog rollback")
        log(f"  5 swap_model(B'', canary=False) {t_forced - t0:.2f} s, its "
            f"commit {forced['commit_ms']:.2f} ms (B' displaced, its "
            f"children joined off the caller's thread): the prober caught "
            f"it and the watchdog rolled back to A {t_back - t_forced:.2f} s "
            f"after the commit; card {card}")

        # 6 and 7: a kill in the prepare window, a corrupted manifest
        plan = faults.FaultPlan([faults.FaultSpec(
            site="serve.swap", action="crash", times=1)], seed=seed)
        with faults.installed(plan):
            try:
                svc.swap_model(path_b1)
                raise AssertionError("the kill in the prepare window did "
                                     "not fire")
            except faults.InjectedCrash:
                pass
        check_still_a(svc, digest_a, a_streams, imgs, "prepare-window kill")
        plan = faults.FaultPlan([faults.FaultSpec(
            site="ckpt.manifest", action="corrupt", flips=64, times=1)],
            seed=seed)
        with faults.installed(plan):
            try:
                svc.swap_model(path_b1)
                raise AssertionError("a corrupted manifest was adopted")
            except ValueError as e:
                refusal = type(e).__name__
        check_still_a(svc, digest_a, a_streams, imgs, "corrupted manifest")
        if native_build.build_count() != builds:
            raise AssertionError("a native build after warmup")
        log(f"  6 a kill in the prepare window (serve.swap): A serving, the "
            f"claim released; 7 a corrupted manifest (ckpt.manifest): "
            f"refused typed ({refusal}); no native build since warmup; "
            f"card {card}")
    finally:
        drained = svc.drain(timeout=SERVE_TIMEOUT_S)
        shutil.rmtree(root, ignore_errors=True)
    if not drained or child_pids() != children0 or shm_segments() != shm0:
        raise AssertionError(f"after the drain: drained {drained}, children "
                             f"{child_pids()}, segments {shm_segments()}")
    log(f"  drain() True; children and dsintorch segments back to "
        f"{len(children0)} and {len(shm0)}")
    return k2


# -- phase 12: the rate-distortion path at full width ----------------------

RD_STEPS, RD_TEST_IMAGES = 12, 2          # a phase of the 3-phase run
SWEEP_TARGETS, SWEEP_STEPS, SWEEP_TEST_IMAGES = (0.02, 0.08), 2, 1
GATE_SHAPES = (("ae_synthetic_micro", (48, 96)),
               ("ae_kitti_stereo", (160, 600)))


def k1_k3_counts() -> dict:
    return {"pearson_argmax": sk.launch_counts["pearson_argmax"],
            "probclass_front_logits":
                pk.launch_counts["probclass_front_logits"]}


def reset_k1_k3() -> None:
    sk.reset_launch_counts()
    pk.reset_launch_counts()


def fronts_of(ae, pc, h: int, w: int) -> int:
    """Wavefronts of one (C, h/8, w/8) volume: K3's launches a pass."""
    codec = make_codec(build_model(ae, pc, device="cpu"))
    return len(codec._wavefronts(ae.num_chan_bn, h // 8, w // 8))


def validations(cfg, steps: int) -> int:
    """Validations of a run of `steps` from step 0 (`main.py`'s schedule:
    every get_validate_every steps, and the last)."""
    return sum(1 for j in range(steps)
               if (j + 1) % main_lib.get_validate_every(
                   j, steps, cfg.validate_every,
                   cfg.get("decrease_val_steps", True)) == 0
               or j + 1 == steps)


def digest_equal(a, b) -> bool:
    return ckpt_lib._tree_digest(a) == ckpt_lib._tree_digest(b)


def rd_3phase(seed: int, dev, root: str, card: str) -> dict:
    """(a): the 3-phase run through the synthetic_rd CLI's configuration,
    then the same command again; -> K1 and K3 launches of the first run."""
    out, data = os.path.join(root, "rd"), os.path.join(root, "data")
    argv = ["-ae_config", config_path("ae_kitti_stereo"), "-pc_config",
            config_path("pc_default"), "--out_root", out, "--data_dir", data,
            "--phase1_steps", str(RD_STEPS), "--phase2_steps", str(RD_STEPS),
            "--max_test_images", str(RD_TEST_IMAGES), "--seed", str(seed)]
    args = synthetic_rd.parse_args(argv)
    ae, pc, corpus_s = synthetic_rd.configs_from_args(args)
    n_val = synthetic_rd.CORPUS_PAIRS[1]
    if corpus_s <= 0 or ae.file_path_val != "synthetic_stereo_val.txt":
        raise AssertionError(f"the CLI did not generate and wire a corpus "
                             f"({corpus_s} s, {ae.file_path_val})")
    h, w = ae.eval_crop_size
    fronts = fronts_of(ae, pc, h, w)
    marks, tests, codecs = {}, collections.defaultdict(list), {}

    def on_restore(phase, exp):
        marks[phase] = time.perf_counter()
        if phase != 2:
            return
        # a fresh phase 2: phase 1's scored AE partitions, a seeded siNet
        live = ckpt_lib.state_from_model(exp.model)
        ckpt = ckpt_lib.restore_partitions(
            os.path.join(exp.weights_root, exp.ae_config.load_model_name),
            live, ckpt_lib.AE_PARTITIONS)
        fresh = ckpt_lib.state_from_model(build_model(
            exp.ae_config, pc, device=dev, seed=seed))
        bad = [p for p in ckpt_lib.AE_PARTITIONS
               if not digest_equal(ckpt.params[p], live.params[p])]
        if (bad or not digest_equal(ckpt.batch_stats, live.batch_stats)
                or not digest_equal(fresh.params["sinet"],
                                    live.params["sinet"])
                or exp.step != 0):
            raise AssertionError(f"phase 2's warm start: partitions {bad} "
                                 f"differ from phase 1's checkpoint, or "
                                 f"siNet is not its seeded init, or step "
                                 f"{exp.step}")

    def on_image(exp, idx, rec):
        phase = 1 if exp.model.ae_only else 2
        tests[phase].append(rec)
        if rec["stream"] is None:
            return
        # the real bpp is the mode-3 stream's, which decodes exactly
        if id(exp) not in codecs:
            codecs[id(exp)] = make_codec(exp.model)
        vol = np.ascontiguousarray(np.transpose(rec["out"]["symbols"][0],
                                                (2, 0, 1)))
        real = len(rec["stream"]) * 8.0 / (h * w)
        if (real != rec["scores"]["real_bpp"]
                or not np.array_equal(codecs[id(exp)].decode(rec["stream"]),
                                      vol)):
            raise AssertionError(f"phase {phase} image {idx}: real bpp "
                                 f"{rec['scores']['real_bpp']} vs its "
                                 f"stream's {real}, or the stream does not "
                                 f"decode to its symbols")

    reset_k1_k3()
    t0 = time.perf_counter()
    r = synthetic_rd.run_3phase(
        ae, pc, args.out_root, phase1_steps=RD_STEPS, phase2_steps=RD_STEPS,
        max_test_images=RD_TEST_IMAGES, device=dev, seed=seed,
        on_restore=on_restore, on_image=on_image)
    run_s = time.perf_counter() - t0
    launches = k1_k3_counts()
    cfg2 = ae.replace(AE_only=False)
    want = {"pearson_argmax": RD_STEPS + validations(cfg2, RD_STEPS) * n_val
            + RD_TEST_IMAGES,
            "probclass_front_logits": 2 * RD_TEST_IMAGES * fronts}
    points = {k: r[k] for k in ("ae_only_test", "with_si_test")}
    finite = all(np.isfinite(v[m]) for v in points.values()
                 for m in ("bpp", "psnr", "ms_ssim"))
    if (not finite or not np.isfinite(points["with_si_test"]["real_bpp"])
            or [len(tests[1]), len(tests[2])] != [RD_TEST_IMAGES] * 2
            or r["phase1"]["steps"] != RD_STEPS
            or r["phase2"]["steps"] != RD_STEPS or launches != want):
        raise AssertionError(f"3-phase run: points {points}, steps "
                             f"{r['phase1']['steps']}/{r['phase2']['steps']},"
                             f" {len(tests[1])}/{len(tests[2])} test images, "
                             f"launches {launches}, expected {want}")
    log(f"  corpus: {sum(synthetic_rd.CORPUS_PAIRS)} synthetic pairs at "
        f"{h}x{w} ({'/'.join(map(str, synthetic_rd.CORPUS_PAIRS))}) "
        f"written in {corpus_s:.1f} s (data/png.py); ae_kitti_stereo's "
        f"KITTI manifests rewired to them")
    log(f"  3-phase run {run_s:.1f} s: phase 1 {marks[2] - marks[1]:.1f} s "
        f"(train {RD_STEPS} steps, validation, AE-only test), phase 2 "
        f"{t0 + run_s - marks[2]:.1f} s (train {RD_STEPS} steps, "
        f"validation, SI test with real bpp); launches {launches} (= "
        f"{RD_STEPS} steps + {validations(cfg2, RD_STEPS)} x {n_val} "
        f"validation batches + {RD_TEST_IMAGES} SI test images; "
        f"{fronts} fronts an encode and a decode); card {card}")
    for phase, key in ((1, "ae_only_test"), (2, "with_si_test")):
        p = points[key]
        ips = r[f"phase{phase}"]["images_per_sec"]
        ms = {k: [rec["ms"][k] for rec in tests[phase]]
              for k in tests[phase][0]["ms"]}
        log(f"  phase {phase}: {1e3 / ips:.1f} ms per train step (StepTimer"
            f", host clock, batch 1 at 320x960), best_val "
            f"{r[f'phase{phase}']['best_val']:.4f}; point bpp {p['bpp']:.4f}"
            + (f", real {p['real_bpp']:.4f}" if "real_bpp" in p else "")
            + f", PSNR {p['psnr']:.2f} dB, MS-SSIM {p['ms_ssim']:.4f}; test "
            f"ms per image " + ", ".join(
                f"{k} " + "/".join(f"{v:.1f}" for v in vals)
                for k, vals in ms.items()) + f"; card {card}")
    log("  phase-2 warm start: the AE partitions and batch statistics of "
        "phase 1's scored checkpoint bit-equal (digests), siNet at its "
        "seeded init, step 0; each SI test image's real bpp its mode-3 "
        "stream's, decoded exactly")

    t0 = time.perf_counter()
    r2 = synthetic_rd.main(argv)
    if r2["phase1"] != r["phase1"] or r2["phase2"]["steps"] != 1:
        raise AssertionError(f"the same command again: phase 1 "
                             f"{r2['phase1']} (was {r['phase1']}), phase 2 "
                             f"{r2['phase2']['steps']} steps")
    log(f"  the same command again ({time.perf_counter() - t0:.1f} s): phase "
        f"1 skipped by its marker, phase 2 resumed from step {RD_STEPS} for "
        f"1 step; with-SI point bpp {r2['with_si_test']['bpp']:.4f}, PSNR "
        f"{r2['with_si_test']['psnr']:.2f}; card {card}")
    return launches


def rd_sweep_phase(seed: int, dev, root: str, card: str) -> int:
    """(b): the sweep at two targets; -> K1's launches."""
    ae, pc = full_configs()
    ae = ae.replace(test_model=True, root_data=os.path.join(root, "data"),
                    **{f"file_path_{s}": f"synthetic_stereo_{s}.txt"
                       for s in ("train", "val", "test")})
    out = os.path.join(root, "sweep")
    reset_k1_k3()
    t0 = time.perf_counter()
    points = rd_sweep.sweep(ae, pc, out_root=out, targets=SWEEP_TARGETS,
                            max_steps=SWEEP_STEPS,
                            max_test_images=SWEEP_TEST_IMAGES, device=dev,
                            seed=seed)
    secs = time.perf_counter() - t0
    launches = k1_k3_counts()
    per_point = (SWEEP_STEPS + validations(ae, SWEEP_STEPS)
                 * synthetic_rd.CORPUS_PAIRS[1] + SWEEP_TEST_IMAGES)
    with open(os.path.join(out, "rd_curve.json")) as f:
        curve = json.load(f)
    if ([p["target_bpp"] for p in curve] != list(SWEEP_TARGETS)
            or any(p["H_target"] != p["target_bpp"] * 64.0 / ae.num_chan_bn
                   for p in curve)
            or curve != json.loads(json.dumps(points))
            or launches != {"pearson_argmax": per_point * len(SWEEP_TARGETS),
                            "probclass_front_logits": 0}):
        raise AssertionError(f"sweep: rd_curve.json {curve}, launches "
                             f"{launches}, expected {per_point} K1 a point")
    log(f"  sweep {secs:.1f} s: rd_curve.json holds "
        + "; ".join(f"target {p['target_bpp']} (H_target {p['H_target']}) "
                    f"bpp {p['bpp']:.4f} PSNR {p['psnr']:.2f}"
                    for p in curve)
        + f"; K1 {launches['pearson_argmax']} = {per_point} a point; card "
        f"{card}")
    return launches["pearson_argmax"]


def rd_delta_phase(seed: int, dev, card: str) -> int:
    """(c): the precision RD-delta gate at its default and at full width;
    -> K3's launches."""
    total = 0
    _, pc = full_configs()
    for name, (h, w) in GATE_SHAPES:
        ae = parse_config_file(config_path(name)).replace(AE_only=True)
        fronts = fronts_of(ae, pc, h, w)
        reset_k1_k3()
        t0 = time.perf_counter()
        res = rd_delta.run_rd_delta(config_path(name),
                                    config_path("pc_default"), h, w,
                                    device=dev, seed=seed)
        secs = time.perf_counter() - t0
        launches = k1_k3_counts()
        want = fronts * 2 * len(precision_lib.RUNGS)
        if (not res["pass"] or not res["streams_bit_identical"]
                or launches != {"pearson_argmax": 0,
                                "probclass_front_logits": want}):
            raise AssertionError(f"rd-delta {name} {h}x{w}: "
                                 f"{res['violations']}, launches {launches},"
                                 f" expected {want} K3")
        total += want
        sha = res["per_rung"]["fp32"]["stream_sha256"]
        log(f"  rd-delta gate, {name} at {h}x{w} ({secs:.1f} s): pass, "
            + "; ".join(
                f"{r} PSNR {e['psnr']:.4f}"
                + (f" (delta {e['psnr_delta']}, MS-SSIM delta "
                   f"{e['msssim_delta']})" if "psnr_delta" in e else "")
                for r, e in res["per_rung"].items())
            + f"; mode-2 / mode-3 streams byte-identical across the rungs "
            f"({sha['wavefront_np'][:16]} / {sha['wavefront_pl'][:16]}); K3 "
            f"{want} = {fronts} fronts x 2 x {len(precision_lib.RUNGS)} "
            f"rungs; card {card}")
    return total


def rd_phase(seed: int, dev) -> dict:
    """Phase 12: (a) the 3-phase run, (b) the sweep, (c) the RD-delta gate;
    returns the K1 and K3 launches of the phase's runs."""
    card = card_line()
    with tempfile.TemporaryDirectory(prefix="dsin-rd-") as root:
        launches = rd_3phase(seed, dev, root, card)
        launches["pearson_argmax"] += rd_sweep_phase(seed, dev, root, card)
    launches["probclass_front_logits"] += rd_delta_phase(seed, dev, card)
    return launches


# -- phase 13: the front door at full width ---------------------------------

FD_QUEUE = 8                   # the overload service's class queues
FD_OVERLOAD = (64, 6.0)        # encodes, a second: ~3x the pipe backend
FD_REPLICAS = (36, 3.0)        # above one thread-backend service's rate
FD_MIX = "interactive:0.125 bulk:0.875"
FD_UNLOADED, FD_SLO_FACTOR = 4, 3.0
FD_SI_JOBS = (0, 1, 2, 3)      # phase 10's 320x1224 images, 2 per side
FD_PROBES = (0, 12)            # a 320x1224 and a 150x590 image
FD_WARM_SI = len(SERVE_BUCKETS)    # K2 launches of a replica's warmup


def fd_args(seed: int, dev, requests: int, rate: float):
    """The serve bench's front-door flags for this phase."""
    return argparse.Namespace(
        ae_config=config_path("ae_kitti_stereo"),
        pc_config=config_path("pc_default"), seed=seed,
        buckets=" ".join(f"{h},{w}" for h, w in SERVE_BUCKETS),
        shapes=f"{H},{W}", max_wait_ms=5.0, entropy_workers=4,
        device=str(dev), replicas=2, priority_mix=FD_MIX,
        interactive_slo_ms=None, bulk_deadline_ms=30000.0,
        frontdoor_rate=rate, frontdoor_requests=requests,
        frontdoor_queue=FD_QUEUE)


def replica_snapshot(router, idx: int) -> dict:
    """One replica's own /metrics JSON (its endpoint, not the merge)."""
    from urllib.request import urlopen
    port = router._replicas[idx].info["healthz_port"]
    with urlopen(f"http://127.0.0.1:{port}/metrics?format=json",
                 timeout=30) as r:
        return json.loads(r.read())


def replica_k2(router, idx: int) -> tuple:
    """-> (K2 launches, SI micro-batches) of one replica, from its own
    registry: the launch gauge and the SI device stage's histogram."""
    snap = replica_snapshot(router, idx)
    return (int(snap["gauges"].get(
                "serve_kernel_launches_pearson_argmax_shared", 0)),
            int(snap["histograms"].get("serve_si_search_ms",
                                       {"count": 0})["count"]))


def check_replica_k2(router, idx: int, extra: int, label: str) -> int:
    """K2 launches of replica idx = its SI micro-batches + its warmup's SI
    warms + `extra`; -> the launches. A batch's futures resolve before its
    worker publishes the launch gauge, so the reading is retried for up
    to 10 s."""
    deadline = time.monotonic() + 10.0
    while True:
        k2, batches = replica_k2(router, idx)
        if k2 == batches + FD_WARM_SI + extra:
            return k2
        if time.monotonic() > deadline:
            raise AssertionError(f"{label}: replica {idx} K2 {k2} != "
                                 f"{batches} SI batches + {FD_WARM_SI} "
                                 f"warms + {extra}")
        time.sleep(0.1)


def fd_overload(seed: int, dev, traffic, card: str, ckpt: str) -> dict:
    """(a): the overload through one in-process service (process backend,
    pipe, depth 2, default_priority_classes(8), admission) on checkpoint
    `ckpt`, its SLO 3x the median of 4 unloaded interactive encodes; then
    the references (b)-(c) hold the fleet to: the probe images' streams,
    and each SI job's stream and decode_si image, one request at a time."""
    from dsin_tpu_torch.serve import BULK, INTERACTIVE
    sides, imgs, owner = traffic
    args = fd_args(seed, dev, *FD_OVERLOAD)
    svc = leg_lib.overload_service(args, enable_si=True, ckpt=ckpt,
                                   entropy_backend="process")
    try:
        warm = svc.warmup()
        sec = leg_lib.run_frontdoor_overload(
            args, images=imgs, svc=svc, unloaded=FD_UNLOADED,
            slo_factor=FD_SLO_FACTOR)
        violations, notes = leg_lib.gate_frontdoor({"overload": sec})
        # the gate's one note on an overload section, a p99 over the SLO
        # while the host's cores read below 1.3, fails here too: the SLO
        # holds whatever the cores read
        violations += notes
        if violations:
            raise AssertionError(f"(a) overload: {violations}; "
                                 f"{json.dumps(sec)[:3000]}")
        futs = {i: svc.submit_encode(imgs[i])
                for i in FD_PROBES + FD_SI_JOBS}
        streams = {i: f.result(SERVE_TIMEOUT_S).stream
                   for i, f in futs.items()}
        probes = [streams[i] for i in FD_PROBES]
        si_streams = {i: streams[i] for i in FD_SI_JOBS}
        sids = [svc.open_session(side) for side in sides]
        si_images = {i: svc.decode_si(si_streams[i], sids[owner[i]],
                                      timeout=SERVE_TIMEOUT_S)
                     for i in FD_SI_JOBS}
    finally:
        drain_checked(svc, [], "(a)")
    unl = sec["unloaded_ms"]
    log(f"  (a) one service (process backend, pipe, depth 2, "
        f"default_priority_classes({FD_QUEUE}), admission): warmup "
        f"{warm['seconds']:.2f} s; {FD_UNLOADED} unloaded interactive "
        f"encodes at {H}x{W}: {', '.join(f'{v:.1f}' for v in unl)} ms, "
        f"median {float(np.median(unl)):.1f} ms -> SLO "
        f"{sec['interactive_slo_ms']:.1f} ms ({FD_SLO_FACTOR:g}x)")
    for cls in (INTERACTIVE, BULK):
        c = sec["per_class"][cls]
        lat = c["latency_ms"]
        log(f"  (a) {cls}: submitted {c['submitted']}, admitted "
            f"{c['admitted']}, shed at the door {c['shed_at_door']} "
            f"(admission {c['shed_admission']}), victims "
            f"{c['shed_victims']}, expired {c['expired']}, completed "
            f"{c['completed']}, p50 {lat['p50']:.1f} ms, p99 "
            f"{lat['p99']:.1f} ms (serve_latency_ms_{cls}, n "
            f"{int(lat['count'])})")
    log(f"  (a) {FD_OVERLOAD[0]} encodes open loop at {FD_OVERLOAD[1]:g}/s, "
        f"mix {FD_MIX}: {sec['duration_s']:.2f} s; sheds bulk first and only "
        f"bulk {sec['shed_total']}; interactive p99 "
        f"{sec['interactive_p99_ms']:.1f} ms within the "
        f"{sec['interactive_slo_ms']:.1f} ms SLO; effective cores {sec['effective_cores']}; no untyped or hung "
        f"future; {sec['steady_builds']} native builds after warmup; "
        f"{host_cores()}, card {card}")
    return dict(probes=probes, si_streams=si_streams, si_images=si_images)


def fd_sessions_and_death(router, ref, traffic, card: str) -> int:
    """(c) on the 2-replica fleet, after (d): sessions pinned to each
    replica, their decode_si bit-equal to the in-process service's;
    replica 1 SIGKILLed with SI work and an encode in flight; -> K2's
    launches read from the replicas (warms, (d)'s prepare and the SI
    micro-batches)."""
    import signal
    from dsin_tpu_torch.serve import SessionExpired
    sides, imgs, owner = traffic
    sids = [router.open_session(side, timeout=SERVE_TIMEOUT_S)
            for side in sides]
    pins = [router._sessions[sid] for sid in sids]
    if pins != [0, 1]:
        raise AssertionError(f"(c) sessions pinned to {pins}, not [0, 1]")

    def si_equal(i, sid, label):
        got = router.decode_si(ref["si_streams"][i], sid,
                               timeout=SERVE_TIMEOUT_S)
        if not np.array_equal(got, ref["si_images"][i]):
            raise AssertionError(f"(c) {label}: decode_si of image {i} "
                                 f"differs from the in-process service's")

    for i in FD_SI_JOBS:
        si_equal(i, sids[owner[i]], f"replica {owner[i]}")
    k2_1 = check_replica_k2(router, 1, FD_WARM_SI, "(c)")
    check_replica_k2(router, 0, FD_WARM_SI, "(c)")
    reroutes0 = router.metrics.counter("serve_router_reroutes").value
    job1 = [i for i in FD_SI_JOBS if owner[i] == 1][0]
    si_futs = [router.submit_decode_si(ref["si_streams"][job1], sids[1])
               for _ in range(4)]
    enc_futs = [router.submit_encode(imgs[FD_PROBES[0]]) for _ in range(2)]
    victim = router._replicas[1].proc
    t_kill = time.perf_counter()
    os.kill(victim.pid, signal.SIGKILL)
    si_exc = [f.exception(SERVE_TIMEOUT_S) for f in si_futs]
    enc = [f.result(SERVE_TIMEOUT_S) for f in enc_futs]
    resolved_s = time.perf_counter() - t_kill
    expired = sum(isinstance(e, SessionExpired) for e in si_exc)
    if expired < 1 or any(e is not None and not isinstance(e, SessionExpired)
                          for e in si_exc):
        raise AssertionError(f"(c) SI futures on the killed replica: "
                             f"{si_exc}")
    reroutes = router.metrics.counter("serve_router_reroutes").value \
        - reroutes0
    if reroutes < 1 or any(r.stream != ref["probes"][0] for r in enc):
        raise AssertionError(f"(c) encodes in flight: {reroutes} reroutes, "
                             f"streams equal "
                             f"{[r.stream == ref['probes'][0] for r in enc]}")
    try:
        router.submit_decode_si(ref["si_streams"][job1], sids[1])
        raise AssertionError("(c) the dead replica's session still pinned")
    except SessionExpired:
        pass
    job0 = [i for i in FD_SI_JOBS if owner[i] == 0][0]
    si_equal(job0, sids[0], "replica 0 after the kill")
    sid_c = router.open_session(sides[1], timeout=SERVE_TIMEOUT_S)
    si_equal(job1, sid_c, "a session opened after the kill")
    orphans = router.metrics.counter("serve_router_session_orphans").value
    health = router.health()
    if orphans < 1 or health["live"] != 1:
        raise AssertionError(f"(c) orphans {orphans}, health {health}")
    k2_0 = check_replica_k2(router, 0, FD_WARM_SI, "(c) after the kill")
    log(f"  (c) 2 sessions pinned to replicas {pins}; "
        f"{len(FD_SI_JOBS)} decode_si bit-equal to the in-process service's "
        f"(K2 in each child: replica 1 {k2_1} launches before the kill = "
        f"SI micro-batches + {FD_WARM_SI} warms + {FD_WARM_SI} in (d)'s "
        f"prepare); SIGKILL of replica 1 "
        f"(pid {victim.pid}) with {len(si_futs)} decode_si and an encode in "
        f"flight: {expired} SessionExpired, "
        f"{len(si_futs) - expired} answered before the kill, {reroutes} "
        f"encode rerouted and answered with the in-process stream, all "
        f"resolved {resolved_s:.2f} s after the kill; replica 0's session "
        f"serves, a new session opened on it; serve_router_session_orphans "
        f"{orphans}; health {health['status']}, live {health['live']}; "
        f"replica 0 K2 {k2_0} = its SI micro-batches + {FD_WARM_SI} warms + "
        f"{FD_WARM_SI} in (d)'s prepare; card {card}")
    return k2_0 + k2_1


def fd_replicas(seed: int, dev, traffic, ref, card: str, ckpts) -> int:
    """(b) the replica axis at 1 and 2 spawned replicas (thread backend,
    4 entropy threads, pipe) on checkpoint A, then on the 2-replica fleet
    (d) the swap to B and back and (c) sessions and a death; -> K2's
    launches read from the replicas."""
    sides, imgs, owner = traffic
    args = fd_args(seed, dev, *FD_REPLICAS)
    k2 = {}

    def on_fleet(n, router):
        if n == 2:
            fd_swap(router, traffic, card, ckpts)
            k2["c"] = fd_sessions_and_death(router, ref, traffic, card)

    sec = leg_lib.run_frontdoor_replicas(
        args, images=imgs, probes=[imgs[i] for i in FD_PROBES],
        config_over={"enable_si": True, "ckpt": ckpts["A"][0]},
        on_fleet=on_fleet)
    violations, notes = leg_lib.gate_frontdoor({"replicas": sec})
    if violations:
        raise AssertionError(f"(b) replicas: {violations}; "
                             f"{json.dumps(sec)[:3000]}")
    probe_sha = [hashlib.sha256(p).hexdigest() for p in ref["probes"]]
    if sec["probe_streams"] != probe_sha:
        raise AssertionError("(b) the fleet's probe streams differ from the "
                             "in-process service's")
    run1 = sec["runs"]["1"]
    k2["b"] = sum(v["pearson_argmax_shared"]
                  for v in run1["kernel_launches"].values())
    if k2["b"] != FD_WARM_SI:
        raise AssertionError(f"(b) N=1 replica K2 {k2['b']} != "
                             f"{FD_WARM_SI} warms")
    for n, run in sec["runs"].items():
        log(f"  (b) N={n}: {run['throughput_rps']:.3f} requests/s "
            f"({run['completed']} of {FD_REPLICAS[0]} at "
            f"{FD_REPLICAS[1]:g}/s in {run['duration_s']:.2f} s), "
            f"scaling_vs_1 {run['scaling_vs_1']}, routed per replica "
            f"{run['per_replica_routed']}, reroutes {run['reroutes']}, shed "
            f"at the door {run['shed_at_door']}; router start "
            f"{run['router_start_s']:.2f} s, replica warmups "
            f"{run['replica_warmup_s']} s, builds_at_ready "
            f"{run['builds_at_ready']}, builds after ready "
            f"{run['builds_after_ready']}")
    log(f"  (b) bit-identical: every replica's probe streams equal each "
        f"other's, N=1's and the in-process service's; scaling floor 1.3 "
        f"{'met' if not notes else 'not met (' + '; '.join(notes) + ')'}; "
        f"host cores {sec['host_cores']} (affinity "
        f"{sec['affinity_cores']}); card {card}")
    return k2["b"] + k2["c"]


def fd_swap(router, traffic, card: str, ckpts) -> None:
    """(d) on (b)'s 2-replica fleet, on checkpoint A since its start:
    swap_model(B) then rollback(); each replica's K2 then = its 2 warms +
    the prepare's 2."""
    from dsin_tpu_torch.coding import loader as loader_lib
    img = traffic[1][FD_PROBES[0]]
    state_b = ckpts["B"][1]
    # B's served digest at fp32: its JAX-layout trees, all float32
    digest_b = loader_lib.params_digest((state_b.params,
                                         state_b.batch_stats))

    def pair():
        out = [router.encode(img, timeout=SERVE_TIMEOUT_S)
               for _ in range(2)]
        if out[0].stream != out[1].stream:
            raise AssertionError("(d) the replicas' streams differ")
        return out[0]

    a = pair()
    digest_a = router.params_digest
    out = router.swap_model(ckpts["B"][0])
    b = pair()
    if (out["digest"] != digest_b or router.params_digest != digest_b
            or b.model_digest != digest_b or b.stream == a.stream):
        raise AssertionError(f"(d) after the commit: digest "
                             f"{out['digest']} / {router.params_digest} / "
                             f"{b.model_digest}, B's {digest_b}")
    back = router.rollback()
    again = pair()
    if back["digest"] != digest_a or again.stream != a.stream:
        raise AssertionError(f"(d) rollback: {back}")
    counts = leg_lib.replica_counts(router)
    if set(counts["builds_after_ready"].values()) != {0}:
        raise AssertionError(f"(d) builds after ready "
                             f"{counts['builds_after_ready']}")
    for i in (0, 1):
        check_replica_k2(router, i, FD_WARM_SI, "(d)")
    prep = out["prepare"]
    log(f"  (d) the 2-replica fleet on A ({digest_a}): swap_model(B) -> "
        f"{out['digest']} (B's digest, both replicas' streams B's and "
        f"equal), rollback() -> {back['digest']} with A's streams; "
        + "; ".join(
            f"replica {i}: prepare {prep[i]['seconds']:.2f} s (load "
            f"{prep[i]['split']['load_s']:.2f}, warm "
            f"{prep[i]['split']['warm_s']:.2f}), commit "
            f"{out['commit_ms'][i]:.2f} ms round trip"
            for i in sorted(prep))
        + f"; K2 per replica {FD_WARM_SI} warms + {FD_WARM_SI} in the "
        f"prepare's warm; no build after ready; card {card}")


def frontdoor_phase(seed: int, dev, ckpts=None) -> int:
    """Phase 13 (see the module docstring); returns K2's launches counted
    in the replicas. `ckpts`: phase 11's checkpoints A and B, written here
    when not given."""
    card = card_line()
    traffic = serve_traffic(seed)
    children0, shm0 = child_pids(), shm_segments()
    root = tempfile.mkdtemp(prefix="chip_smoke_fd_")
    try:
        if ckpts is None:
            ckpts = life_checkpoints(seed, root)
        ref = fd_overload(seed, dev, traffic, card, ckpts["A"][0])
        k2 = fd_replicas(seed, dev, traffic, ref, card, ckpts)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if child_pids() != children0 or shm_segments() != shm0:
        raise AssertionError(f"phase 13 left children {child_pids()} or "
                             f"segments {shm_segments()}")
    return k2


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    card = card_line()
    rows, launches, walls = {}, {}, []

    def phase(title, fn):
        log(f"[{len(walls) + 2}/13] {title}")
        t0 = time.perf_counter()
        out = fn()
        walls.append((len(walls) + 2, time.perf_counter() - t0))
        return out

    log(f"[1/13] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    phase("build", build_phase)
    rows.update(phase(f"kernel vs plain at {H}x{W}, patches {PH}x{PW}, seed "
                      f"{args.seed}", lambda: kernel_phase(args.seed, dev)))
    launches.update(phase("the slice at full width (ae_kitti_stereo + "
                          "pc_default)", lambda: slice_phase(args.seed, dev)))
    rows["probclass_front_logits"], launches["probclass_front_logits"] = \
        phase("the codec at full width (ae_kitti_stereo + pc_default)",
              lambda: codec_phase(args.seed, dev))

    def ladder():
        rows["fused_decode_epilogue"] = k4_phase(args.seed, dev)
        launches["fused_decode_epilogue"] = leg_phase(args.seed, dev)

    phase("the precision ladder: K4 and the serve-bench precision leg "
          "(ae_kitti_stereo + pc_default)", ladder)
    phase("the test run at full width (ae_kitti_stereo + pc_default) from a "
          "checkpoint the port wrote", lambda: test_run_phase(args.seed, dev))
    phase("training at full width (ae_kitti_stereo + pc_default, 320x960, "
          "batch 1)", lambda: train_phase(args.seed, dev))
    phase("the rest of the patch search (tiled, scores, L2/LAB) and the "
          "Cityscapes geometry (1024x2048, 16x32 patches)",
          lambda: search_phase(args.seed, dev))
    launches["pearson_argmax_shared"] += phase(
        "the compression service at full width (ae_kitti_stereo + "
        "pc_default, buckets 160x600 and 320x1224, batches of 4)",
        lambda: service_phase(args.seed, dev))
    # checkpoints A and B, written once for phases 11 and 13
    life_root = tempfile.mkdtemp(prefix="chip_smoke_ckpts_")
    life = {}

    def lifecycle():
        life.update(life_checkpoints(args.seed, life_root))
        return lifecycle_phase(args.seed, dev, life)

    launches["pearson_argmax_shared"] += phase(
        "the model lifecycle at full width: publish, swap under load, "
        "rollback, canary refusal, watchdog, faults (process backend, "
        "pipe)", lifecycle)
    for name, n in phase(
            "the rate-distortion path at full width (ae_kitti_stereo + "
            "pc_default): the 3-phase run, the sweep, the RD-delta gate",
            lambda: rd_phase(args.seed, dev)).items():
        launches[name] += n
    launches["pearson_argmax_shared"] += phase(
        "the front door at full width: priority classes and admission "
        "under overload, the FrontDoorRouter over 1 and 2 spawned replicas "
        "on this card, session pinning and a replica's death, the fleet "
        "swap and rollback", lambda: frontdoor_phase(args.seed, dev, life))
    shutil.rmtree(life_root, ignore_errors=True)
    log("phase wall s: " + ", ".join(f"[{i}] {t:.1f}" for i, t in walls))
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name], **r)
               for name, r in rows.items()]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
