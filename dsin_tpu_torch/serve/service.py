"""Long-lived compression service on one card (counterpart of the JAX
package's `serve/service.py` `CompressionService`).

The model is loaded once (`coding/loader.load_model_state`, from a seed or
a checkpoint of either package); requests of any (h, w) are padded onto
the static bucket set (`serve/buckets.py`) and same-bucket requests
coalesce into micro-batches (`serve/batcher.py`), each padded to
`max_batch` so every batch has one of `2 * len(buckets)` (+ the SI ones)
shapes, as in the JAX package. SIGINT/SIGTERM drain gracefully
(`utils/signals.py`): in-flight batches complete, queued requests are
rejected with ServiceDraining, new submits are refused.

The device stage is `serve/device.py` `DeviceServer` (encoder ->
quantizer; centers -> decoder -> clip; and with `enable_si` the decode
through the cached session prep, the search kernel K2 and siNet). The
entropy stage codes in mode 2, the numpy engine, as the JAX service does,
so streams are byte-identical to the JAX service's for the same symbols.

Pipelined dataplane: with `entropy_workers > 0` each worker runs a
two-stage pipeline, one pool task per micro-batch:

  encode:  [worker] assemble + launch the device batch on the worker's
                    own CUDA stream; a non-blocking copy of the symbols
                    into pinned host memory and an event recorded after it
           [pool]   wait on that event (never on the whole device), one
                    batch call of the rANS coder, frame + resolve futures
  decode:  [pool]   per-request CRC re-verify, decode each payload
           [worker] the batched decode (or the SI decode) over the
                    gathered symbols, crop + resolve futures

The worker launches batch N+1's device stage while batch N's entropy task
runs on the pool (`pipeline_depth` bounds the batches in flight). Every
pool thread owns a private codec clone (`BottleneckCodec.thread_clone`)
sharing the warmed, lock-guarded schedule cache. Fault isolation holds
inside the batch task: the `serve.rans` site and the payload-CRC re-verify
run per request, and an IntegrityError lands on that request's future
only. A worker that dies mid-pipeline flushes its in-flight records on
the way out and the supervisor restarts it with capped exponential
backoff (`utils/retry.py`). `/healthz` degrades honestly (`degraded`
below the configured pool size, `unhealthy` + 503 at zero).

CUDA streams across threads: each worker enters `torch.inference_mode`
and its own `torch.cuda.Stream` on its thread (both are per-thread
state). `open_session` builds the prep on the caller's stream and waits
on an event recorded after it before the prep enters the session store,
so no worker stream can read it early; a batch's `_Inflight` record keeps
its session entry until `_finish_batch` has waited on the batch's event,
so an evicted prep is freed only after the last batch that read it.

Stream framing (little-endian, v2), around the BottleneckCodec payload:
    b"DSRV" | u8 version | u16 h | u16 w | u16 bh | u16 bw
            | u32 payload_len | u32 crc32 | payload
The CRC covers every header field after the magic plus the payload
(`utils/integrity.py`); v1 frames (no CRC) remain readable.

Side-information serving (`enable_si`): `open_session(y)` runs the prep
once (AE-reconstruct y, transform, window statistics, prior factors and
the kernel's operands) into an immutable `ops.sifinder.SidePrep` held in
the LRU/TTL/byte-bounded `serve/session.py` store;
`submit_decode_si(stream, session_id)` decodes through it. Requests that
share a session coalesce into one micro-batch (`Request.session`), one
K2 launch each.

Process entropy backend (`entropy_backend="process"`): the entropy
stage's coding work runs in a spawn-context `ProcessPoolExecutor` of
worker-resident codecs (`coding/loader.py` `CodecSpec`: rebuilt once per
child as a host codec, schedules warmed there, mode 2 only; a child never
initialises CUDA). The pool threads become bridges: the device-to-host
transfer, the per-request `serve.rans` fault site and CRC re-verify,
framing and futures. A payload in another mode than 2 (a client's mode-3
stream) is decoded on the bridge thread through the bundle's codec, K3 on
the card, never in a child. `transport="shm"` moves task and result
payloads through CRC-framed lanes of one shared-memory ring per pool
generation (`serve/shmlane.py`), all allocated and freed by the parent;
only a descriptor crosses the pipe. A killed child breaks the pool: it is
rebuilt once and the task retried (`serve_entropy_proc_rebuilds`); a
child that hangs past `entropy_proc_timeout_s` fails its batch with a
typed TimeoutError and its pool is replaced and its children killed.

Live model operations (`serve/swap.py`): every dataplane stage reads the
`ModelBundle` its worker captured at batch start, so a batch is
version-coherent by construction. `prepare_swap(ckpt_dir)` restores the
incoming checkpoint into a copy of the live model's trees, verifies its
manifest (`coding/loader.load_swap_state`: typed `ManifestMismatch` on a
wrong params digest, pc-config hash or bucket ladder, or no manifest),
re-casts it onto the service's rung, loads it onto the card on the
caller's thread (`DeviceServer.sync` before anything stages), warms it
through every bucket (K2 on the SI path), starts its own pool of children
on the process backend, and with goldens in its manifest probes the
STAGED bundle (`CanaryFailed` refuses it); `commit_swap` is a pointer
swap under the coordinator's lock, the displaced model kept warm for an
instant `rollback()`. A commit or rollback clears the session store
(preps embed the old weights: clients get `SessionExpired` and re-open).
No native build happens in any of it: K2's library is keyed by its
source, not by weights. The post-commit `RollbackWatchdog` on the
supervisor thread compares typed-error rates around every commit and
watches the committed digest for a canary failure, and rolls back
CONDITIONALLY (`expect_current`) by itself.

Model health (`serve/quality.py`): bpp and the head-sampled coding gap
per bucket after an encode's futures resolve; per-session SI-match scores
where the search returns them (`ops/sifinder.service_si_scores`: on the
CPU, not on the card, where K2 folds them); the golden canary
(`run_canary`, and a prober thread behind `canary_every_s`) drives pinned
inputs through the real serve path and compares digests against the
serving model's manifest goldens or its self-anchored first probe.

Observability: the JAX service's metric names (`serve_device_ms`,
`serve_entropy_ms`, `serve_overlap_ratio`, `serve_si_prep_ms`,
`serve_si_search_ms`, `serve_sessions_*`, `serve_swaps`,
`serve_rollbacks`, `serve_swap_errors`, `serve_watchdog_*`,
`serve_canary_*`, `serve_coding_gap_pct_<bh>x<bw>`, `serve_bpp_*`,
`serve_si_match_*`, ...), plus per-kind `serve_device_ms_<kind>` /
`serve_entropy_ms_<kind>` histograms; with no XLA, `serve_native_builds`
and `serve_warmup_builds` count native builds
(`native_build.build_count()`) where the JAX service counts compiles.
Spans and flight events as in `serve/trace.py`, plus the JAX service's
lifecycle events (`swap_prepared`, `swap_commit`, `swap_abort`,
`swap_rollback`, `watchdog_verdict`, `quality_alarm`, `canary_failure`,
`canary_refused_swap`).

Priority classes and admission: with `priority_classes` (e.g.
`batcher.default_priority_classes(max_queue)`) the batcher keeps a bounded
queue per class with its default deadline and sheds the lowest class first
(`serve_shed_<cls>` counts the victims), and the router's
`AdmissionController` (`serve/router.py`) gates the door BEFORE enqueue:
per-class outstanding (queued + in-flight) caps from `admission_limits` or
`router.default_admission_limits`, a typed `ServiceOverloaded` at the cap
(`serve_admitted_<cls>`, `serve_shed_admission_<cls>`), the slot released
when the request's future resolves. `serve_latency_ms_<cls>` holds each
class's latency. The worker keeps an express lane for the first class
(`_oldest_first`, which the JAX worker has not): its batches finish before
any lower class's in flight, and while the worker waits on a lower-class
batch's entropy (several times one request's on the card) a first-class
submit wakes it to start that batch at once, one over `pipeline_depth` at
most. A front door's `trace` context, passed to a submit,
replaces the one the service would mint, so one trace id indexes the
router hop and the replica's spans. The card's kernel launches
(`ops/sifinder_kernel.launch_counts`) are published as
`serve_kernel_launches_<name>` gauges and the `serve_kernel_launches` info
entry, so a replica's counts are readable from its endpoint.

Not ported, and refused with NotImplementedError naming the ROADMAP item:
more than one device and placement. `persistent_cache` (the XLA compile
cache) has no meaning here and is not a field.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import struct
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED
from concurrent.futures import Future as PoolFuture
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures import wait as futures_wait
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dsin_tpu_torch import native_build
from dsin_tpu_torch.coding import loader as loader_lib
from dsin_tpu_torch.coding.codec import MODE_WAVEFRONT_NP
from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.runtime import resolve_device
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.ops import sifinder_kernel as sk
from dsin_tpu_torch.serve import buckets as buckets_lib
from dsin_tpu_torch.serve import metrics as metrics_lib
from dsin_tpu_torch.serve import quality as quality_lib
from dsin_tpu_torch.serve import router as router_lib
from dsin_tpu_torch.serve import session as session_lib
from dsin_tpu_torch.serve import shmlane as shmlane_lib
from dsin_tpu_torch.serve import swap as swap_lib
from dsin_tpu_torch.serve import trace as trace_lib
from dsin_tpu_torch.serve.batcher import (Future, MicroBatcher, Request,
                                          ServeError, ServiceDraining,
                                          ServiceUnavailable)
from dsin_tpu_torch.serve.device import DeviceServer
from dsin_tpu_torch.train import checkpoint as ckpt_lib
from dsin_tpu_torch.utils import faults
from dsin_tpu_torch.utils.integrity import (IntegrityError, frame_crc,
                                            verify_crc)
from dsin_tpu_torch.utils.retry import RetryPolicy

SERVE_MAGIC = b"DSRV"
SERVE_VERSION = 2   # v2: + CRC32 over header fields + payload
_FRAME_LEN_V1 = 17  # magic(4) + B(1) + 4*H(8) + I(4)
_FRAME_LEN = 21     # v2: + I(4) CRC

ENCODE = "encode"
DECODE = "decode"
DECODE_SI = "decode_si"   # session-affine SI decode

#: the ROADMAP Queue 1 item naming what the port's service does not have yet
ROADMAP_DEVICES = "ROADMAP Queue 1 item 11c (devices > 1 and placement)"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to dsin_tpu_torch yet: "
                               f"{item}")


@dataclass
class ServiceConfig:
    """The JAX service's configuration, less what the port does not serve:
    `persistent_cache` does not exist (there is no XLA cache). `device` is
    the card by default; without one the service raises unless it is
    "cpu"."""
    ae_config: str
    pc_config: str
    ckpt: Optional[str] = None
    seed: int = 0
    buckets: Sequence[Tuple[int, int]] = buckets_lib.DEFAULT_BUCKETS
    max_batch: int = 4
    max_wait_ms: float = 5.0
    max_queue: int = 64
    #: executor threads, each with its own CUDA stream
    workers: int = 1
    #: None or 1; more raises (ROADMAP_DEVICES), as do placement knobs
    devices: Optional[int] = None
    placement_weights: Optional[dict] = None
    rebalance_check_every_s: Optional[float] = None
    #: rANS pool size; 0 = serialized path (entropy inline on the worker
    #: thread after/before the device call); None = min(4, cores - 1),
    #: at least 1
    entropy_workers: Optional[int] = None
    #: where the entropy stage codes: "thread" (the pool threads, each
    #: with its codec clone) or "process" (a spawn-context process pool
    #: of worker-resident mode-2 codecs, the pool threads bridging to
    #: it); "process" needs entropy_workers > 0
    entropy_backend: str = "thread"
    #: process backend: ceiling on one micro-batch's task in a child,
    #: including a rebuilt pool's spawn and codec warm; on expiry the
    #: batch fails with TimeoutError and the pool is replaced
    entropy_proc_timeout_s: float = 120.0
    #: process backend payload transport: "pipe" (pickled through the
    #: pool's pipe) or "shm" (CRC-framed shared-memory lanes, only a
    #: descriptor on the pipe; streams byte-equal to "pipe")
    transport: str = "pipe"
    #: max batches a worker holds in flight (device launched, entropy
    #: pending) before finishing the oldest; >= 2 overlaps batch N's
    #: entropy with batch N+1's device stage
    pipeline_depth: int = 2
    #: traffic classes, most latency-sensitive first (e.g.
    #: batcher.default_priority_classes(max_queue)): per-class bounded
    #: queues, default deadlines, the bulk-sheds-first overload order, and
    #: the AdmissionController gate at the door. None = one "default"
    #: class, no gate
    priority_classes: Optional[Sequence] = None
    #: per-class outstanding (queued + in-flight) caps for the admission
    #: gate; None = router.default_admission_limits (the class queue bound
    #: + the worker pipelines' in-flight capacity). Only read with
    #: priority_classes
    admission_limits: Optional[Mapping[str, int]] = None
    #: load the full DSIN (siNet included) and open the session API
    #: (open_session/submit_decode_si); every bucket edge must divide by
    #: the config's y_patch_size
    enable_si: bool = False
    session_max: int = 8
    session_max_bytes: int = 64 * 1024 * 1024
    session_ttl_s: Optional[float] = None
    #: request tracing + flight recorder (serve/trace.py)
    trace_enabled: bool = True
    trace_sample_rate: float = 0.0
    trace_capacity: int = 4096
    flight_capacity: int = 2048
    flight_dir: Optional[str] = None
    flight_dump_min_interval_s: float = 1.0
    #: post-swap rollback watchdog: compare typed-error-rate windows
    #: before and after every commit_swap and roll back by itself when
    #: the rate jumps by more than `rollback_watchdog_threshold` over at
    #: least `rollback_watchdog_min_requests` post-commit resolutions (or
    #: at once on a canary failure of the committed model). None = off.
    rollback_watchdog_window_s: Optional[float] = None
    rollback_watchdog_threshold: float = 0.5
    rollback_watchdog_min_requests: int = 8
    #: model-health telemetry (serve/quality.py); False removes the layer:
    #: no bpp / gap observation, no SI scores, no canary
    quality_enabled: bool = True
    #: head-sampling rate of the coding-gap pass (a second engine pass on
    #: the entropy-pool thread per sampled encode)
    quality_gap_sample_rate: float = 1.0 / 16.0
    #: SI-match alarm: a session is alarmed once >= `si_alarm_frac` of its
    #: winning match scores (after `si_alarm_min_samples` of them) fall
    #: below `si_score_floor`
    si_score_floor: float = 0.25
    si_alarm_frac: float = 0.5
    si_alarm_min_samples: int = 8
    #: golden canary prober period; None = no background prober (a swap
    #: still probes its staged bundle when the incoming manifest records
    #: goldens and quality_enabled)
    canary_every_s: Optional[float] = None
    #: seed of the pinned canary inputs; must match the publisher's
    canary_seed: int = 0
    #: per-op result timeout inside one canary probe
    canary_timeout_s: float = 120.0
    #: precision-ladder rung (coding/precision.py)
    precision: str = "fp32"
    #: None = no HTTP endpoint; 0 = ephemeral port (tests)
    metrics_port: Optional[int] = None
    #: supervisor restart backoff: base and cap of the exponential curve
    restart_backoff_s: float = 0.05
    restart_backoff_max_s: float = 2.0
    #: how often the supervisor checks the pool for dead workers
    supervise_every_s: float = 0.05
    device: str = "cuda"


def _refused(config: ServiceConfig) -> Optional[NotImplementedError]:
    """The NotImplementedError a configuration asks for, or None."""
    if config.devices not in (None, 1):
        return _not_ported(f"devices={config.devices}", ROADMAP_DEVICES)
    if (config.placement_weights is not None
            or config.rebalance_check_every_s is not None):
        return _not_ported("placement and rebalance", ROADMAP_DEVICES)
    return None


def _validate_knobs(config: ServiceConfig, n_buckets: int) -> None:
    """The entropy-backend and canary knobs, checked before the model build
    as the JAX service checks them: a typo costs milliseconds, typed."""
    if config.canary_every_s is not None and config.canary_every_s <= 0:
        raise ValueError(f"canary_every_s must be > 0 (or None), got "
                         f"{config.canary_every_s}")
    if config.canary_timeout_s <= 0:
        raise ValueError(f"canary_timeout_s must be > 0, got "
                         f"{config.canary_timeout_s}")
    if (config.canary_every_s is not None and config.enable_si
            and config.session_max < n_buckets + 1):
        # the prober's pinned sessions (one per bucket) live in the shared
        # store and take part in its LRU like any client
        raise ValueError(
            f"canary_every_s with enable_si needs session_max >= "
            f"{n_buckets + 1} (one pinned canary session per bucket + at "
            f"least one user slot), got {config.session_max} — budget the "
            f"prober's sessions into the store or disable the background "
            f"canary")
    if config.entropy_backend not in ("thread", "process"):
        raise ValueError(f"entropy_backend must be 'thread' or 'process', "
                         f"got {config.entropy_backend!r}")
    ew = config.entropy_workers
    if config.entropy_backend == "process" and ew is not None and ew <= 0:
        raise ValueError("entropy_backend='process' needs entropy_workers "
                         "> 0 (the process pool IS the entropy stage)")
    if config.entropy_proc_timeout_s <= 0:
        raise ValueError(f"entropy_proc_timeout_s must be > 0, got "
                         f"{config.entropy_proc_timeout_s}")
    if config.transport not in ("pipe", "shm"):
        raise ValueError(f"transport must be 'pipe' or 'shm', got "
                         f"{config.transport!r}")


@dataclass
class EncodeResult:
    stream: bytes          # framed: ready for decode() / a wire
    payload_bytes: int     # entropy-coded payload only
    bpp: float             # payload bits over ORIGINAL h*w pixels
    shape: Tuple[int, int]
    bucket: Tuple[int, int]
    #: digest of the model bundle that produced this stream
    model_digest: Optional[str] = None


def frame_stream(payload: bytes, shape: Tuple[int, int],
                 bucket: Tuple[int, int]) -> bytes:
    h, w = shape
    bh, bw = bucket
    head = struct.pack("<BHHHHI", SERVE_VERSION, h, w, bh, bw, len(payload))
    crc = frame_crc(head, payload)
    return SERVE_MAGIC + head + struct.pack("<I", crc) + payload


class StreamCorrupt(ValueError):
    """Structurally damaged DSRV frame (bad magic, truncation, version
    or geometry skew); a ValueError for every caller that catches the
    documented base."""


def parse_stream(blob: bytes):
    """-> (payload, (h, w), (bh, bw)); every corruption mode is a typed
    error — StreamCorrupt (a ValueError subclass) for structural
    damage, IntegrityError (also under ValueError) for a v2 CRC
    mismatch. v1 frames predate the CRC and parse without one."""
    if len(blob) < _FRAME_LEN_V1 or blob[:4] != SERVE_MAGIC:
        raise StreamCorrupt("not a DSRV stream")
    version = blob[4]
    if version == 1:
        version, h, w, bh, bw, n = struct.unpack(
            "<BHHHHI", blob[4:_FRAME_LEN_V1])
        payload = blob[_FRAME_LEN_V1:_FRAME_LEN_V1 + n]
        crc = None
    elif version == SERVE_VERSION:
        if len(blob) < _FRAME_LEN:
            raise StreamCorrupt(f"truncated DSRV v2 header: {len(blob)} "
                                f"of {_FRAME_LEN} bytes")
        version, h, w, bh, bw, n, crc = struct.unpack(
            "<BHHHHII", blob[4:_FRAME_LEN])
        payload = blob[_FRAME_LEN:_FRAME_LEN + n]
    else:
        raise StreamCorrupt(f"unsupported DSRV version {version}")
    if len(payload) != n:
        raise StreamCorrupt(f"truncated stream: payload {len(payload)} "
                            f"of {n} bytes")
    if crc is not None:
        verify_crc(crc, "DSRV stream",
                   struct.pack("<BHHHHI", version, h, w, bh, bw, n),
                   payload)
    if h > bh or w > bw:
        raise StreamCorrupt(f"corrupt frame: image ({h}, {w}) exceeds "
                            f"its own bucket ({bh}, {bw})")
    return payload, (h, w), (bh, bw)


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host batch onto the device: on the card through pinned memory, a
    copy ordered on the current stream that does not block the host."""
    t = torch.from_numpy(arr)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _to_host(t: torch.Tensor):
    """-> (host tensor, event or None). On the card: a non-blocking copy
    into pinned memory on the current stream, then an event recorded after
    it; the host values are valid once the event completes."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _host_array(host: torch.Tensor, event) -> np.ndarray:
    if event is not None:
        event.synchronize()     # this batch's copy only, not the device
    return host.numpy()


def _prep_nbytes(prep) -> int:
    """Device bytes of a SidePrep: the sum of its tensors' bytes."""
    return sum(t.numel() * t.element_size() for t in prep
               if isinstance(t, torch.Tensor))


class _DeviceBatch:
    """One launched encode batch. The worker moves on to the next batch
    while the device computes; the FIRST entropy task to need the symbols
    waits on the batch's event (its copy to pinned memory) and converts,
    siblings block briefly on the lock and share it. `device_ms` therefore
    measures the start of the launch (`dispatched`) -> results on the
    host: launch + queueing + compute + copy."""

    __slots__ = ("_lock", "_pinned", "_event", "_host", "dispatched",
                 "transfer_done")

    def __init__(self, pinned: torch.Tensor, event, dispatched: float):
        self._lock = threading.Lock()
        self._pinned = pinned                # guarded-by: self._lock
        self._event = event                  # guarded-by: self._lock
        self._host = None                    # guarded-by: self._lock
        self.dispatched = dispatched
        self.transfer_done: Optional[float] = None  # guarded-by: self._lock

    def host(self) -> np.ndarray:
        with self._lock:
            if self._host is None:
                self._host = _host_array(self._pinned, self._event)
                self._pinned = self._event = None
                self.transfer_done = time.monotonic()
            return self._host

    @property
    def device_ms(self) -> float:
        with self._lock:
            done = self.transfer_done
        if done is None:
            done = time.monotonic()
        return (done - self.dispatched) * 1e3


class _Inflight:
    """One batch moving through the pipeline: the worker's handle for
    finishing it (wait for entropy tasks; decode's device stage) and the
    per-batch ledger the stage metrics come from."""

    __slots__ = ("kind", "batch", "bucket", "t0", "bundle", "tasks",
                 "handle", "sym", "per_item_exc", "crash", "si_entry")

    def __init__(self, kind, batch, bucket, t0, bundle):
        self.kind = kind
        self.batch = batch
        self.bucket = bucket
        self.t0 = t0
        #: the ONE ModelBundle every stage of this batch reads
        self.bundle = bundle
        self.tasks = []
        self.handle: Optional[_DeviceBatch] = None   # encode
        self.sym: Optional[np.ndarray] = None        # decode gather
        self.per_item_exc = {}
        self.crash: Optional[BaseException] = None
        #: DECODE_SI: the SessionEntry captured at batch start — the
        #: device stage reads ITS prep, and holding it here keeps the prep
        #: alive until the batch's device work has finished
        self.si_entry = None


class _EntropyPool:
    """One process-pool GENERATION: the ProcessPoolExecutor plus (shm
    transport) the lane ring its children attached at init. It answers the
    two calls the service makes of a pool (`submit`, `shutdown`);
    shutdown unlinks the ring with the pool, so a wedged child's late
    reply lands in a detached mapping and hurts nobody. Every lane (task
    and reply) is allocated and freed by the parent: the bridge thread
    blocks on the reply, so there is no cross-process free to get
    wrong."""

    def __init__(self, pool: ProcessPoolExecutor, rings, reply_bytes: int):
        self.pool = pool
        self.rings = rings          # None = pipe transport
        self.reply_bytes = int(reply_bytes)

    def submit(self, fn, *args, **kwargs):
        return self.pool.submit(fn, *args, **kwargs)

    def shutdown(self, wait: bool = False, kill: bool = False) -> None:
        """Refuse new work, and with `kill` SIGKILL the children first (a
        wedged child would otherwise outlive the service: the interpreter
        joins every pool at exit)."""
        if kill:
            # ProcessPoolExecutor has no public terminate before 3.14
            for proc in list((self.pool._processes or {}).values()):
                proc.kill()
        self.pool.shutdown(wait=wait)
        if self.rings is not None:
            self.rings.unlink()


class CompressionService:
    """Thread-per-worker micro-batching codec service on one device.

    Lifecycle:  start() -> [warmup()] -> submit_*/encode/decode ...
                -> drain()   (or initiate_drain() from a signal handler)
    """

    def __init__(self, config: ServiceConfig):
        err = _refused(config)
        if err is not None:
            raise err
        self.config = config
        self.policy = buckets_lib.BucketPolicy(config.buckets)
        self.metrics = metrics_lib.MetricsRegistry()
        self.tracer = trace_lib.Tracer(
            sample_rate=config.trace_sample_rate,
            capacity=config.trace_capacity,
            enabled=config.trace_enabled, metrics=self.metrics)
        self.flight = trace_lib.FlightRecorder(
            capacity=config.flight_capacity, dump_dir=config.flight_dir,
            min_dump_interval_s=config.flight_dump_min_interval_s,
            metrics=self.metrics, enabled=config.trace_enabled)
        self._watchdog: Optional[swap_lib.RollbackWatchdog] = None
        if config.rollback_watchdog_window_s is not None:
            self._watchdog = swap_lib.RollbackWatchdog(
                config.rollback_watchdog_window_s,
                config.rollback_watchdog_threshold,
                config.rollback_watchdog_min_requests)
        # model-health telemetry: built up front like the tracer (the
        # constructors validate the knobs), so every stage can reach
        # self.quality without a None check
        self.quality = quality_lib.QualityMonitor(
            metrics=self.metrics, flight=self.flight,
            enabled=config.quality_enabled,
            gap_sample_rate=config.quality_gap_sample_rate,
            si_score_floor=config.si_score_floor,
            si_alarm_frac=config.si_alarm_frac,
            si_alarm_min_samples=config.si_alarm_min_samples)
        self._canary = quality_lib.CanaryState(
            config.canary_seed, self.metrics, flight=self.flight)
        self._canary_imgs = {}        # bucket -> (img, side), pinned
        self._canary_sids = {}        # bucket -> live canary session id
        self._canary_thread: Optional[threading.Thread] = None
        # threads retiring the bundles commits displaced (wait_drained
        # joins them before the last bundles retire);
        # guarded-by: self._workers_lock
        self._retirers: List[threading.Thread] = []
        self._warmup_done = False
        #: whether the SI decode returns the winning scores (start())
        self._si_scores_enabled = False
        self._si_route: Optional[str] = None
        #: the parsed configs every bundle is built from (start())
        self._ae_cfg = None
        self._pc_cfg = None
        self._batcher = MicroBatcher(
            config.max_batch, config.max_wait_ms, config.max_queue,
            classes=config.priority_classes,
            on_expired=self._note_expired, on_shed=self._note_shed)
        self._priority_enabled = config.priority_classes is not None
        self._admission: Optional[router_lib.AdmissionController] = None
        if self._priority_enabled:
            limits = config.admission_limits
            if limits is None:
                limits = router_lib.default_admission_limits(config)
            self._admission = router_lib.AdmissionController(
                limits, metrics=self.metrics)
        # the express lane: futures a first-class submit resolves, one per
        # worker waiting on a lower class's batch (`_oldest_first`)
        self._express_lock = threading.Lock()
        self._express_waiters = set()      # guarded-by: self._express_lock
        self._workers = []                 # guarded-by: self._workers_lock
        self._workers_lock = threading.Lock()
        # slot -> last fatal exit / consecutive restarts / restart time
        self._worker_exits = {}            # guarded-by: self._workers_lock
        self._restarts = []                # guarded-by: self._workers_lock
        self._restart_at = []              # guarded-by: self._workers_lock
        self._restart_policy = RetryPolicy(
            max_attempts=1 << 30,          # supervise forever; the cap is
            base_delay_s=config.restart_backoff_s,      # on the DELAY
            max_delay_s=config.restart_backoff_max_s,
            backoff=2.0)
        self._supervisor: Optional[threading.Thread] = None
        self._closer: Optional[threading.Thread] = None
        self._started = False
        self._draining = threading.Event()
        self._metrics_server: Optional[metrics_lib.MetricsServer] = None
        self._batch_hook = None   # test/diagnostic: called with each batch
        self._entropy_pool: Optional[ThreadPoolExecutor] = None
        self._entropy_workers = 0
        #: per-bucket (D, H, W) symbol volume shapes the codecs warm
        self._warm_shapes = []
        #: warmup's worker-residence pings, one per pool child
        self._proc_warm = []
        self._codec_local = threading.local()
        self._si_enabled = False
        self._sessions: Optional[session_lib.SessionStore] = None
        self._bn_channels = 0
        self.device: Optional[torch.device] = None
        self._swap: Optional[swap_lib.SwapCoordinator] = None

    # -- model state (always the CURRENT bundle's view) ----------------------

    @property
    def server(self) -> Optional[DeviceServer]:
        """The DeviceServer of the model currently serving."""
        return self._swap.current.server if self._swap is not None else None

    @property
    def codec(self):
        return self._swap.current.codec if self._swap is not None else None

    @property
    def model_digest(self) -> Optional[str]:
        """`coding/loader.params_digest` of the serving model (at fp32 the
        JAX service's digest of the same weights)."""
        return self._swap.current.digest if self._swap is not None else None

    @property
    def metrics_port(self) -> Optional[int]:
        """The port /healthz, /metrics and /trace answer on (None without
        an endpoint)."""
        srv = self._metrics_server
        return srv.port if srv is not None else None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "CompressionService":
        if self._started:
            return self
        _validate_knobs(self.config, len(self.policy.buckets))
        # the device first: without a card this raises in milliseconds
        self.device = resolve_device(self.config.device)
        self._si_enabled = bool(self.config.enable_si)
        self._ae_cfg = parse_config_file(self.config.ae_config).replace(
            AE_only=not self._si_enabled)
        self._pc_cfg = parse_config_file(self.config.pc_config)
        if self._si_enabled:
            ph, pw = (int(v) for v in self._ae_cfg.y_patch_size)
            bad = [b for b in self.policy.buckets
                   if b[0] % ph or b[1] % pw]
            if bad:
                raise ValueError(
                    f"enable_si needs every bucket edge divisible by "
                    f"y_patch_size ({ph}, {pw}) — the siFinder patch "
                    f"grid must tile the bucket exactly; offending "
                    f"buckets: {bad}")
            # the SI-score decision: scores only where the search is not
            # the kernel (K2 folds them on the card)
            self._si_route, self._si_scores_enabled = \
                sifinder_lib.service_si_scores(
                    self._ae_cfg, self.device.type,
                    self.config.quality_enabled)
            # the evict hook keeps the SI-match tracker from holding
            # stats or alarms for sessions that no longer exist
            self._sessions = session_lib.SessionStore(
                self.config.session_max, self.config.session_max_bytes,
                self.config.session_ttl_s, metrics=self.metrics,
                flight=self.flight, on_evict=self.quality.session_gone)
        # the start bundle keeps its checkpoint's manifest too: the canary
        # compares against publisher goldens from the very first model
        model, record = loader_lib.build_at_rung(
            self._ae_cfg, self._pc_cfg, device=self.device,
            seed=self.config.seed, precision=self.config.precision,
            ckpt_dir=self.config.ckpt)
        self._bn_channels = int(model.ae_config.num_chan_bn)
        sub = buckets_lib.SUBSAMPLING
        self._warm_shapes = [(self._bn_channels, bh // sub, bw // sub)
                             for bh, bw in self.policy.buckets]
        ew = self.config.entropy_workers
        if ew is None:
            ew = max(1, min(4, (os.cpu_count() or 2) - 1))
        self._entropy_workers = ew
        if ew > 0:
            self._entropy_pool = ThreadPoolExecutor(
                max_workers=ew, thread_name_prefix="serve-entropy")
        if self.config.entropy_backend == "process":
            self.metrics.counter("serve_entropy_proc_rebuilds")
        bundle = self._make_bundle(0, model, self.config.ckpt,
                                   record["manifest"] if record else None)
        self._swap = swap_lib.SwapCoordinator(bundle, self.metrics)
        self.metrics.set_info("serve_entropy_backend", {
            "backend": self.config.entropy_backend,
            "transport": self.config.transport, "entropy_workers": ew,
            "pipeline_depth": self.config.pipeline_depth})
        with self._workers_lock:
            for i in range(self.config.workers):
                self._workers.append(self._spawn_worker(i))
                self._restarts.append(0)
                self._restart_at.append(None)
        self.metrics.gauge("serve_workers_live").set(self.config.workers)
        self.metrics.gauge("serve_devices").set(1)
        self._supervisor = threading.Thread(target=self._supervise_loop,
                                            name="serve-supervisor",
                                            daemon=True)
        self._supervisor.start()
        # golden canary: pinned inputs at the EXISTING bucket shapes (the
        # warmed paths, no native build), probed by a thread of its own so
        # a slow probe never stalls the supervisor's healing
        self._canary_imgs = quality_lib.canary_inputs(
            self.policy.buckets, self.config.canary_seed)
        if self.config.canary_every_s is not None \
                and self.config.quality_enabled:
            self._canary_thread = threading.Thread(
                target=self._canary_loop, name="serve-canary", daemon=True)
            self._canary_thread.start()
        if self.config.metrics_port is not None:
            self._metrics_server = metrics_lib.MetricsServer(
                self.metrics, self.health,
                port=self.config.metrics_port,
                trace=self._trace_http).start()
        self._started = True
        return self

    def _trace_http(self, params) -> object:
        """The /trace endpoint body: the span ring (`?id=` filters one
        trace, `?format=chrome` exports the Chrome/Perfetto event dict)
        plus the flight recorder's ring and dump bookkeeping."""
        if params.get("format") == "chrome":
            return self.tracer.http_snapshot(params)
        snap = self.tracer.http_snapshot(params)
        snap["flight"] = self.flight.meta()
        return snap

    def _make_bundle(self, epoch: int, model, ckpt: Optional[str],
                     manifest: Optional[dict]) -> swap_lib.ModelBundle:
        """One model version as a ModelBundle: its served digest, its
        DeviceServer (the weights complete on the device before this
        returns: `sync` on the caller's stream, so no worker stream reads
        them half-copied), its codec, and on the process backend its own
        CodecSpec file (in a directory the bundle removes when it retires)
        and its own pool of children, spawned at the first submit."""
        server = DeviceServer.for_model(model)
        server.sync()
        codec = loader_lib.make_codec(model)
        initargs = spec_dir = None
        if self.config.entropy_backend == "process":
            spec_dir = tempfile.mkdtemp(prefix="dsin-serve-spec-")
            initargs = (loader_lib.write_codec_spec(
                loader_lib.make_codec_spec(codec, rung=self.config.precision),
                os.path.join(spec_dir, "codec-spec.pkl")),
                list(self._warm_shapes))
        bundle = swap_lib.ModelBundle(
            epoch, loader_lib.served_digest(model, self.config.precision),
            server, codec, ckpt=ckpt, proc_initargs=initargs,
            manifest=manifest, spec_dir=spec_dir)
        if initargs is not None:
            bundle.set_proc(self._make_entropy_proc(initargs))
        return bundle

    def _warm_device(self, bundle: swap_lib.ModelBundle) -> None:
        """Run every bucket's device functions once on `bundle` (encode,
        decode, and with SI a session prep and an SI decode, K2 on the
        card), and prime its codec's schedule for each bucket's volume with
        one entropy round trip. The same shapes for every bundle, so a
        swap's warm builds nothing."""
        server = bundle.server
        sub = buckets_lib.SUBSAMPLING
        n = self.config.max_batch
        for bh, bw in self.policy.buckets:
            symbols = server.encode_symbols(
                np.zeros((n, bh, bw, 3), np.float32)).cpu().numpy()
            sym = np.zeros((n, bh // sub, bw // sub, self._bn_channels),
                           np.int32)
            server.decode(sym)
            if self._si_enabled:
                prep = server.open_session(np.zeros((bh, bw, 3), np.float32))
                server.decode_si(sym, prep,
                                 with_scores=self._si_scores_enabled)
            stream = bundle.codec.encode(np.transpose(symbols[0], (2, 0, 1)))
            bundle.codec.decode(stream)
        server.sync()

    def warmup(self) -> dict:
        """Run every (bucket, direction) once, and with SI a session prep
        and an SI decode per bucket; prime the codec's schedules with one
        entropy round trip per bucket; start the entropy pool threads (each
        builds its codec clone) and, on the process backend, every pool
        child (spawn, codec rebuild, schedule warm) and ping it, so the
        first request pays nothing. Returns {"builds": native builds during
        warmup, "seconds": s}; the pings land in `_proc_warm`. After it,
        serving builds nothing (`native_build.build_count()` holds), the
        port's counterpart of the JAX service's zero-compile census, and
        the canary prober may run."""
        if not self._started:
            raise RuntimeError("start() before warmup()")
        t0 = time.monotonic()
        before = native_build.build_count()
        bundle = self._swap.current
        self._warm_device(bundle)
        if self._entropy_pool is not None:
            # force every pool thread into existence and build its codec
            # clone now (the barrier keeps the tasks on distinct threads)
            barrier = threading.Barrier(self._entropy_workers)

            def _prime():
                barrier.wait(timeout=60)
                self._thread_codec(bundle)

            for f in [self._entropy_pool.submit(_prime)
                      for _ in range(self._entropy_workers)]:
                f.result(timeout=120)
        if bundle.proc() is not None:
            self._proc_warm = self._ping_children(bundle)
        builds = native_build.build_count() - before
        self._warmup_done = True
        self.metrics.gauge("serve_warmup_builds").set(builds)
        self.metrics.gauge("serve_buckets").set(len(self.policy.buckets))
        self._publish_launches()
        return {"builds": builds, "seconds": time.monotonic() - t0}

    def _ping_children(self, bundle, timeout_s: float = 300.0) -> list:
        """One `worker_ping` answer per pool child. The first submits spawn
        every child at once; pings go out in rounds until each child has
        answered one (its initializer done), so no child is still warming
        when the first batch arrives. Raises TimeoutError when a child has
        not answered within `timeout_s`."""
        pings = {}
        deadline = time.monotonic() + timeout_s
        while len(pings) < self._entropy_workers:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{self._entropy_workers - len(pings)} entropy children "
                    f"did not answer a ping within {timeout_s} s")
            futs = [bundle.proc().submit(loader_lib.worker_ping, 0.2)
                    for _ in range(self._entropy_workers)]
            for f in futs:
                ping = f.result(timeout=timeout_s)
                pings.setdefault(ping["pid"], ping)
        return list(pings.values())

    # -- live model operations ----------------------------------------------

    def prepare_swap(self, ckpt_dir: str, canary: bool = True) -> dict:
        """Load, verify and warm an incoming checkpoint into a STAGED
        ModelBundle while the dataplane keeps serving the current one (this
        runs on the CALLER's thread). Manifest-verified: a wrong params
        digest, pc-config hash or bucket ladder, or a checkpoint without a
        manifest, raises typed ManifestMismatch and nothing stages. The
        float32 weights are verified, then re-cast onto this service's rung
        and loaded onto the device (complete before anything stages, see
        `_make_bundle`); the warm drives every bucket's device functions
        with them (the shapes the service already runs: no native build)
        and, on the process backend, spawns and pings the bundle's own
        children.

        Golden canary gate: when the incoming manifest records `canary`
        goldens (and quality telemetry is on), the STAGED bundle is probed
        and a digest mismatch raises typed `CanaryFailed` before the model
        answers a single request. `canary=False` is the operator override
        (the post-commit prober and the watchdog remain the safety net).
        Returns {"digest", "epoch", "ckpt", "warm", "canary", "seconds",
        "split"}: `split` is the seconds of the load, the warm, the pool
        start and the canary probe. commit_swap() makes it live."""
        if not (self._started and self._warmup_done):
            raise RuntimeError("start() + warmup() before a hot swap")
        epoch = self._swap.begin_prepare()
        t0 = time.monotonic()
        bundle = None
        try:
            template = ckpt_lib.state_from_model(
                self._swap.current.server.model)
            new_state, info = loader_lib.load_swap_state(
                ckpt_dir, template, pc_config=self._pc_cfg,
                buckets=self.policy.buckets, need_sinet=self._si_enabled)
            # the prepare window: a kill here leaves the service serving
            # the old model with the claim released
            faults.inject("serve.swap")
            model, _ = loader_lib.build_at_rung(
                self._ae_cfg, self._pc_cfg, device=self.device,
                seed=self.config.seed, precision=self.config.precision,
                state=new_state)
            bundle = self._make_bundle(epoch, model, ckpt_dir,
                                       info.get("manifest"))
            t_load = time.monotonic()
            warm = self._warm_bundle(bundle)
            t_warm = time.monotonic()
            canary_info = {"status": "disabled"}
            if canary and self.config.quality_enabled:
                # probe AFTER the warm and BEFORE the stage: a failing
                # canary leaves nothing to commit
                canary_info = self._canary_check_bundle(bundle)
            t_canary = time.monotonic()
            self._swap.stage(bundle)
        except BaseException:
            # InjectedCrash included: the service keeps serving the old
            # model; release the claim, retire the partial bundle
            if bundle is not None:
                bundle.retire()
            self._swap.abandon_prepare()
            raise
        self.flight.record("swap_prepared", digest=bundle.digest,
                           ckpt=ckpt_dir)
        return {"digest": bundle.digest, "epoch": epoch, "ckpt": ckpt_dir,
                "warm": warm, "canary": canary_info,
                "seconds": round(time.monotonic() - t0, 3),
                "split": {"load_s": round(t_load - t0, 3),
                          "warm_s": warm["device_s"],
                          "pool_s": warm["pool_s"],
                          "canary_s": round(t_canary - t_warm, 3)}}

    def _warm_bundle(self, bundle: swap_lib.ModelBundle) -> dict:
        """The incoming bundle through every bucket's device functions and
        its codec's schedules (`_warm_device`), then, on the process
        backend, its children spawned, warmed and pinged."""
        t0 = time.monotonic()
        self._warm_device(bundle)
        t1 = time.monotonic()
        pings = (self._ping_children(bundle) if bundle.proc() is not None
                 else [])
        return {"buckets": len(self.policy.buckets),
                "proc_workers": len(pings),
                "device_s": round(t1 - t0, 3),
                "pool_s": round(time.monotonic() - t1, 3)}

    def commit_swap(self, expect_digest: Optional[str] = None) -> dict:
        """Make the staged bundle live: a pointer swap under the
        coordinator's lock. In-flight batches finish on the bundle they
        captured; the displaced model stays warm for rollback().
        `expect_digest` pins which model the caller believes it is
        committing."""
        if not self._started:
            raise RuntimeError("start() before commit_swap()")
        # the commit window: a kill HERE leaves current serving and the
        # staged bundle parked (the caller aborts it)
        faults.inject("serve.swap")
        self._retire_off_thread(self._swap.commit(expect_digest))
        # sessions are model-versioned: their preps embed the OLD
        # weights' y-hat; clients re-open
        self._invalidate_sessions("swap")
        snap = self._swap.snapshot()
        self.flight.record("swap_commit", digest=snap["digest"],
                           prev=snap["prev_digest"])
        if self._watchdog is not None:
            errors, resolved = self._error_counters()
            self._watchdog.arm(time.monotonic(), snap["digest"],
                               errors, resolved)
        return snap

    def _retire_off_thread(self, bundles: List[swap_lib.ModelBundle]) -> None:
        """Retire the bundles a commit displaced on a thread of their own:
        joining a pool's children takes seconds, and the commit is a pointer
        swap on the caller's thread (the JAX package's `retire` does not wait
        for its pool either). Batches that captured such a bundle finish
        their submitted tasks before its ring is unlinked."""
        if not bundles:
            return

        def _retire():
            for b in bundles:
                b.retire()

        t = threading.Thread(target=_retire, name="serve-retire",
                             daemon=True)
        with self._workers_lock:
            self._retirers = [r for r in self._retirers if r.is_alive()]
            self._retirers.append(t)
        t.start()

    def _error_counters(self) -> Tuple[int, int]:
        """(typed errors, resolutions): the watchdog's inputs, both counted
        in one place (`_note_resolution`)."""
        return (self.metrics.counter("serve_typed_errors").value,
                self.metrics.counter("serve_resolved").value)

    def abort_swap(self) -> dict:
        """Discard the staged bundle (its children reaped, its spec file
        and lane segments released) or cancel a prepare still loading; safe
        when nothing is staged. The current bundle keeps serving."""
        if not self._started:
            raise RuntimeError("start() before abort_swap()")
        for b in self._swap.abort():
            b.retire()
        self.flight.record("swap_abort")
        return self._swap.snapshot()

    def swap_model(self, ckpt_dir: str, canary: bool = True) -> dict:
        """The one-call hot swap: prepare (load, verify, warm, canary when
        the manifest records goldens) then commit. Any failure (manifest
        mismatch, canary refusal, a kill in either window) aborts back to
        the old model; the service never stops serving. `canary=False` is
        the operator override. The result is prepare_swap's, with the
        commit's own `commit_ms`."""
        info = self.prepare_swap(ckpt_dir, canary=canary)
        t0 = time.monotonic()
        try:
            self.commit_swap(expect_digest=info["digest"])
        except BaseException:
            self.abort_swap()
            raise
        info["commit_ms"] = round(1e3 * (time.monotonic() - t0), 3)
        return info

    def rollback(self, expect_current: Optional[str] = None) -> dict:
        """Re-instate the previous model bundle: instant (its weights never
        left the device, its pool never stopped). `expect_current` makes it
        conditional: only if the serving digest IS that one (a typed
        `ConditionalRollbackRefused` otherwise)."""
        if not self._started:
            raise RuntimeError("start() before rollback()")
        for b in self._swap.rollback(expect_current=expect_current):
            b.retire()
        if self._watchdog is not None:
            # a rollback (operator or watchdog) supersedes any pending
            # judgement: never judge a model that already left
            self._watchdog.disarm()
        self._invalidate_sessions("rollback")
        snap = self._swap.snapshot()
        self.flight.record("swap_rollback", digest=snap["digest"])
        return snap

    def _invalidate_sessions(self, reason: str) -> None:
        """Drop every cached SidePrep (the serving weights changed: a stale
        prep would search against the wrong y-hat). Clients see typed
        SessionExpired and re-open."""
        if self._sessions is not None and self._sessions.live:
            self._sessions.clear(reason)

    def rebalance_placement(self, weights=None) -> dict:
        raise _not_ported("rebalance_placement", ROADMAP_DEVICES)

    # -- golden canary ------------------------------------------------------

    def canary_goldens(self, staged: bool = False) -> dict:
        """The `manifest_extra["canary"]` entry a checkpoint publisher
        records: golden output digests of the CURRENT model, or with
        `staged` of a prepared, uncommitted bundle (the publish flow:
        prepare the candidate, record what it SHOULD produce, abort,
        re-save the checkpoint with the goldens)."""
        if not (self._started and self._warmup_done):
            raise RuntimeError("start() + warmup() before canary_goldens()")
        bundle = self._swap.staged if staged else self._swap.current
        if bundle is None:
            raise swap_lib.SwapError(
                "canary_goldens(staged=True) with nothing staged — "
                "prepare_swap first")
        return quality_lib.goldens_struct(
            self.config.canary_seed, self.policy.buckets,
            self._canary_probe_bundle(bundle))

    def _canary_probe_bundle(self, bundle) -> dict:
        """The pinned canary inputs through one bundle's device functions
        and codec, on the caller's thread, and every output digested: lane
        0 of a max_batch-padded batch, as the dataplane assembles one, so
        the digests equal what the serve path gives for the same model
        (a lane's result does not depend on its batchmates; the tests pin
        the equality)."""
        server = bundle.server
        sub = buckets_lib.SUBSAMPLING
        digests = {}
        for bucket in self.policy.buckets:
            bh, bw = bucket
            img, side = self._canary_imgs[bucket]
            x = np.zeros((self.config.max_batch, bh, bw, 3), np.float32)
            x[0] = buckets_lib.pad_to_bucket(
                img.astype(np.float32, copy=False), bucket)
            symbols = server.encode_symbols(x).cpu().numpy()
            payload = bundle.codec.encode(np.transpose(symbols[0], (2, 0, 1)))
            stream = frame_stream(payload, (bh, bw), bucket)
            entry = {"encode": quality_lib.digest_bytes(stream)}
            sym = np.zeros((self.config.max_batch, bh // sub, bw // sub,
                            self._bn_channels), np.int32)
            sym[0] = np.transpose(bundle.codec.decode(payload), (1, 2, 0))
            out = server.decode(sym).cpu().numpy()
            entry["decode"] = quality_lib.digest_bytes(
                buckets_lib.crop_from_bucket(out[0], (bh, bw))
                .astype(np.uint8).tobytes())
            entry["decode_si"] = None
            if self._si_enabled:
                prep = server.open_session(buckets_lib.pad_to_bucket(
                    side.astype(np.float32, copy=False), bucket))
                si_out = server.decode_si(sym, prep,
                                          with_scores=self._si_scores_enabled)
                if self._si_scores_enabled:
                    si_out = si_out[0]
                entry["decode_si"] = quality_lib.digest_bytes(
                    buckets_lib.crop_from_bucket(
                        si_out.cpu().numpy()[0], (bh, bw))
                    .astype(np.uint8).tobytes())
            digests[quality_lib.bucket_key(bucket)] = entry
        return digests

    def _canary_check_bundle(self, bundle) -> dict:
        """Prepare-time canary: probe a staged bundle against ITS
        manifest's goldens. A manifest without goldens skips (recorded);
        goldens that mismatch, or that cannot be compared (another canary
        seed, a served bucket they do not cover), refuse typed
        `CanaryFailed`."""
        goldens = (bundle.manifest or {}).get("canary")
        if goldens is None:
            self.metrics.counter("serve_canary_swap_skipped").inc()
            return {"status": "skipped",
                    "reason": "checkpoint manifest records no canary "
                              "goldens"}
        observed = self._canary_probe_bundle(bundle)
        mismatches = quality_lib.compare_goldens(
            goldens, observed, seed=self.config.canary_seed,
            buckets=self.policy.buckets)
        if mismatches:
            self.metrics.counter("serve_canary_swap_refusals").inc()
            self.flight.record("canary_refused_swap",
                               digest=bundle.digest,
                               mismatches=mismatches[:8])
            raise quality_lib.CanaryFailed(
                f"staged model {bundle.digest} failed its golden canary "
                f"— its outputs are not the outputs its manifest "
                f"promises; refusing to commit it: "
                f"{'; '.join(mismatches[:4])}")
        self.metrics.counter("serve_canary_swap_passes").inc()
        return {"status": "passed", "buckets": len(observed)}

    def run_canary(self) -> dict:
        """One canary probe through the REAL serve path (encode, decode and
        decode_si on a pinned canary session per bucket), compared against
        the serving model's baseline: its manifest's goldens when they are
        comparable, else the self-anchored first probe of this digest. A
        digest MISMATCH is definitive: it fails the canary, dumps the
        flight recorder, and tells the watchdog when one watches this
        model. Typed serve errors during the probe (a drain, a swap
        expiring the canary session mid-probe) are infrastructure, counted
        apart, never a canary failure. One probe at a time: a caller that
        finds one running gets {"status": "busy"}."""
        if not (self._started and self._warmup_done):
            raise RuntimeError("start() + warmup() before run_canary()")
        if not self.config.quality_enabled:
            return {"status": "disabled"}
        if not self._canary.claim():
            return {"status": "busy"}
        try:
            return self._run_canary_claimed()
        finally:
            self._canary.release()

    def _run_canary_claimed(self) -> dict:
        t0 = time.monotonic()
        timeout = self.config.canary_timeout_s
        start_digest = self.model_digest
        bundle = self._swap.current
        observed, bucket_ms = {}, {}
        try:
            for bucket in self.policy.buckets:
                tb = time.monotonic()
                img, side = self._canary_imgs[bucket]
                res = self.encode(img, timeout=timeout)
                entry = {"encode": quality_lib.digest_bytes(res.stream)}
                dec = self.decode(res.stream, timeout=timeout)
                entry["decode"] = quality_lib.digest_bytes(dec.tobytes())
                entry["decode_si"] = None
                if self._si_enabled:
                    si = self._canary_decode_si(bucket, side, res.stream,
                                                timeout)
                    entry["decode_si"] = quality_lib.digest_bytes(
                        si.tobytes())
                observed[quality_lib.bucket_key(bucket)] = entry
                bucket_ms[quality_lib.bucket_key(bucket)] = round(
                    (time.monotonic() - tb) * 1e3, 1)
        except (ServeError, ValueError, TimeoutError) as e:
            # typed infrastructure trouble: the probe learned nothing
            # about quality
            self.metrics.counter("serve_canary_errors").inc()
            result = {"status": "error", "digest": start_digest,
                      "error": type(e).__name__}
            self._canary.note_result(result)
            return result
        if self.model_digest != start_digest:
            # a swap or rollback landed mid-probe: the digests mix two
            # models; judge neither
            self.metrics.counter("serve_canary_races").inc()
            result = {"status": "raced", "digest": start_digest}
            self._canary.note_result(result)
            return result
        source, mismatches = self._canary.baseline_for(
            start_digest, bundle.manifest, self.policy.buckets, observed)
        ms = (time.monotonic() - t0) * 1e3
        self.metrics.counter("serve_canary_runs").inc()
        self.metrics.histogram("serve_canary_ms").observe(ms)
        if mismatches:
            self.metrics.counter("serve_canary_failures").inc()
            self.metrics.gauge("serve_canary_ok").set(0)
            result = {"status": "failed", "digest": start_digest,
                      "baseline": source, "mismatches": mismatches}
            self._canary.note_result(result)
            self.flight.note_death("canary_failure", digest=start_digest,
                                   baseline=source,
                                   mismatches=mismatches[:8])
            if self._watchdog is not None:
                self._watchdog.note_canary_failure(start_digest)
            return result
        self.metrics.gauge("serve_canary_ok").set(1)
        result = {"status": "ok", "digest": start_digest,
                  "baseline": source, "ms": round(ms, 1),
                  "bucket_ms": bucket_ms}
        self._canary.note_result(result)
        return result

    def _canary_decode_si(self, bucket, side, stream, timeout):
        """The SI leg of one probe on the pinned canary session, re-opened
        once when the store expired it (LRU pressure, a swap's clear); a
        second expiry inside one probe propagates as the probe's typed
        error."""
        sid = self._canary_sids.get(bucket)
        if sid is None:
            sid = self._canary_sids[bucket] = self.open_session(side)
        try:
            return self.decode_si(stream, sid, timeout=timeout)
        except session_lib.SessionExpired:
            sid = self._canary_sids[bucket] = self.open_session(side)
            return self.decode_si(stream, sid, timeout=timeout)

    def _canary_loop(self) -> None:
        """The prober thread: one run_canary per period once warmup ran.
        Errors are counted, never fatal: the prober outlives everything
        but the drain."""
        while not self._draining.wait(self.config.canary_every_s):
            if not self._warmup_done:
                continue
            try:
                self.run_canary()
            except Exception:   # noqa: BLE001 — the prober must survive
                self.metrics.counter("serve_canary_errors").inc()

    # -- drain ----------------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def initiate_drain(self) -> None:
        """Non-blocking drain trigger — safe from a signal handler: flip
        the flag, then close the queue from a FRESH thread (the handler may
        interrupt the main thread while it holds the batcher's lock inside
        submit(); closing inline there would self-deadlock).
        `drain()`/`wait_drained()` does the blocking part."""
        if self._draining.is_set():
            return
        self._draining.set()

        def _close():
            rejected = self._batcher.close()
            self.metrics.counter("serve_rejected_drain").inc(rejected)

        self._closer = threading.Thread(target=_close, name="serve-drain",
                                        daemon=True)
        self._closer.start()

    def wait_drained(self, timeout: Optional[float] = 30.0) -> bool:
        if self._closer is not None:
            self._closer.join(timeout)
        if self._supervisor is not None:
            # the supervisor exits once draining is set; join it first so
            # no restart races the worker joins below
            self._supervisor.join(timeout)
        if self._canary_thread is not None:
            # the prober exits on the drain flag too; a probe in flight
            # resolves typed (the queue is closing), counted as an error
            self._canary_thread.join(timeout)
        with self._workers_lock:
            workers = list(self._workers)
        for t in workers:
            t.join(timeout)
        alive = any(t.is_alive() for t in workers)
        if not alive:
            if self._entropy_pool is not None:
                # workers flushed their pipelines before exiting, so the
                # pool is idle; shutdown is immediate (and idempotent)
                self._entropy_pool.shutdown(wait=True)
            with self._workers_lock:
                retirers = list(self._retirers)
            for t in retirers:
                t.join(timeout)
            if self._swap is not None:
                # every bundle (current, prev, staged) retires: its pool's
                # children exit, its lane ring is unlinked, its spec file
                # removed
                for b in self._swap.all_bundles():
                    b.retire()
            if self._sessions is not None:
                # drained services hold no device-resident preps
                self._sessions.clear("drain")
            if self._metrics_server is not None:
                self._metrics_server.stop()
                self._metrics_server = None
            # stop the flight-dump thread AFTER the pipeline flushed:
            # typed errors raised by the drain itself still dump
            self.flight.flush(timeout=5.0)
            self.flight.close()
        return not alive

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Graceful shutdown: returns True when every worker exited."""
        self.initiate_drain()
        return self.wait_drained(timeout)

    def install_signal_handlers(self) -> bool:
        """SIGINT/SIGTERM -> initiate_drain (main thread only)."""
        from dsin_tpu_torch.utils.signals import install_drain_handlers
        return install_drain_handlers(self.initiate_drain)

    def __enter__(self) -> "CompressionService":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.drain()

    # -- request intake -----------------------------------------------------

    @property
    def live_workers(self) -> int:
        with self._workers_lock:
            return sum(t.is_alive() for t in self._workers)

    def health(self) -> dict:
        live = self.live_workers
        configured = self.config.workers if self._started else 0
        if self.draining:
            status = "draining"
        elif live == 0:
            status = "unhealthy"       # /healthz answers 503
        elif live < configured:
            status = "degraded"        # still serving; pool being healed
        else:
            status = "ok"
        return {"status": status,
                "queue_depth": self._batcher.depth,
                "buckets": [list(b) for b in self.policy.buckets],
                "devices": 1,
                "device": str(self.device),
                "workers_live": live,
                "workers_configured": configured,
                "worker_restarts":
                    self.metrics.counter("serve_worker_restarts").value,
                "model": (self._swap.snapshot()
                          if self._swap is not None else {}),
                **({"sessions": {"live": self._sessions.live,
                                 "bytes": self._sessions.bytes_used}}
                   if self._sessions is not None else {}),
                # model health (absent with quality off): the last canary
                # verdict and how many sessions are alarmed
                **({"quality": {
                        "canary": self._canary.last,
                        "si_alarms": self.metrics.gauge(
                            "serve_si_match_alarms").value}}
                   if self.config.quality_enabled else {})}

    def _deadline(self, deadline_ms: Optional[float]) -> Optional[float]:
        return (None if deadline_ms is None
                else time.monotonic() + deadline_ms / 1000.0)

    def _note_expired(self, n: int, by_class) -> None:
        """Batcher on_expired hook (runs under the batcher lock —
        metrics only): total + per-class deadline counters."""
        self.metrics.counter("serve_rejected_deadline").inc(n)
        for cls, k in by_class.items():
            self.metrics.counter(f"serve_expired_{cls}").inc(k)

    def _note_shed(self, cls: str, n: int) -> None:
        """Batcher on_shed hook: per-class overload-victim counter (the
        bulk-sheds-first evidence the front-door leg reads)."""
        self.metrics.counter(f"serve_shed_{cls}").inc(n)

    def _submit(self, request: Request) -> Future:
        # admission is where a request's TraceContext is minted, unless a
        # front door passed its own (its sampling decision rides along)
        if request.trace is None:
            request.trace = self.tracer.mint()
        request.future.trace = request.trace
        # the drain flag flips before the queue actually closes (the
        # close runs on the serve-drain thread) — refuse here too so no
        # request slips into that window
        if self._draining.is_set():
            self.metrics.counter("serve_rejected_drain").inc()
            self.flight.record("shed", reason="draining")
            raise ServiceDraining("service is draining; not accepting "
                                  "new requests")
        if self._started and self.live_workers == 0:
            # nothing would drain the queue: fail fast and let the client
            # retry elsewhere while the supervisor heals the pool
            self.metrics.counter("serve_rejected_unavailable").inc()
            self.flight.record("shed", reason="no_workers")
            raise ServiceUnavailable(
                "no live workers (pool is restarting); retry shortly")
        cls = None
        if self._admission is not None:
            # the gate BEFORE enqueue: a shed here costs one counter read,
            # nothing was queued
            cls = request.priority or self._batcher.default_class
            request.priority = cls
            try:
                self._admission.admit(cls)
            except Exception:
                self.metrics.counter("serve_rejected_overload").inc()
                self.flight.record("shed", reason="admission", cls=cls)
                raise
        try:
            self._batcher.submit(request)
        except ServiceDraining:
            if cls is not None:
                self._admission.release(cls)
            self.metrics.counter("serve_rejected_drain").inc()
            self.flight.record("shed", reason="draining")
            raise
        except Exception:
            if cls is not None:
                self._admission.release(cls)
            self.metrics.counter("serve_rejected_overload").inc()
            self.flight.record("shed", reason="queue_full",
                               cls=request.priority)
            raise
        if cls is not None:
            # attached AFTER a successful enqueue: any resolution (result,
            # shed as a victim, expiry, drain, crash) frees the slot
            self._admission.attach(cls, request.future)
            if cls == self._batcher.default_class:
                self._wake_express()
        # typed-error visibility: ANY typed resolution counts, tags the
        # trace and triggers a flight dump (an already-resolved future
        # fires the callback immediately)
        request.future.add_done_callback(self._note_resolution)
        self.flight.record("admit", cls=request.priority,
                           key=str(request.key))
        # counted only once ACCEPTED: submitted - completed bounds the
        # queued+in-flight backlog
        self.metrics.counter("serve_submitted").inc()
        self.metrics.gauge("serve_queue_depth").set(self._batcher.depth)
        return request.future

    def _note_resolution(self, fut: Future) -> None:
        """Done-callback on every accepted request: a TYPED error (the
        ServeError/ValueError/InjectedFault families — IntegrityError and
        SessionExpired are subclasses) counts into `serve_typed_errors`,
        records the always-on error span and triggers a flight dump. May
        run under the batcher condition, so nothing here blocks."""
        exc = fut.exception(timeout=0)
        self.metrics.counter("serve_resolved").inc()
        if exc is None or not isinstance(
                exc, (ServeError, ValueError, faults.InjectedFault)):
            return
        self.metrics.counter("serve_typed_errors").inc()
        ctx = getattr(fut, "trace", None)
        self.tracer.error(ctx, exc)
        self.flight.note_error(
            exc, trace_id=ctx.trace_id if ctx is not None else None)

    def submit_encode(self, img: np.ndarray,
                      deadline_ms: Optional[float] = None,
                      priority: Optional[str] = None,
                      trace=None) -> Future:
        """(h, w, 3) uint8/float image -> Future[EncodeResult]. Raises
        ServiceOverloaded/ServiceDraining/NoBucketFits at the door.
        `priority` names a configured traffic class (None = the most
        latency-sensitive one; its default deadline applies when
        `deadline_ms` is None). `trace` is a front door's TraceContext
        whose sampling decision this service honours; None = mint one."""
        img = np.asarray(img)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"expected (h, w, 3) image, got {img.shape}")
        h, w = img.shape[:2]
        bucket = self.policy.bucket_for(h, w)
        padded = buckets_lib.pad_to_bucket(
            img.astype(np.float32, copy=False), bucket)
        return self._submit(Request(
            key=(ENCODE, bucket), payload=(padded, (h, w)),
            deadline=self._deadline(deadline_ms), priority=priority,
            trace=trace))

    def _stream_bucket(self, blob: bytes):
        payload, shape, bucket = parse_stream(blob)
        if bucket not in self.policy.buckets:
            raise buckets_lib.NoBucketFits(
                f"stream was encoded for bucket {bucket}, which this "
                f"service does not serve (buckets: "
                f"{list(self.policy.buckets)})")
        return payload, shape, bucket

    def submit_decode(self, blob: bytes,
                      deadline_ms: Optional[float] = None,
                      priority: Optional[str] = None,
                      trace=None) -> Future:
        """Framed DSRV stream -> Future[(h, w, 3) uint8 image]. A v2
        frame failing its CRC raises IntegrityError here, at the door."""
        payload, shape, bucket = self._stream_bucket(blob)
        # the payload's own CRC rides along so the worker re-verifies
        # right before the entropy decode — catches corruption that
        # happens AFTER admission (the serve.rans fault site's scenario)
        return self._submit(Request(
            key=(DECODE, bucket), payload=(payload, shape,
                                           frame_crc(payload)),
            deadline=self._deadline(deadline_ms), priority=priority,
            trace=trace))

    # -- side-information sessions --------------------------------------------

    def _require_si(self) -> session_lib.SessionStore:
        if not self._si_enabled:
            raise session_lib.SessionError(
                "this service was started without enable_si — it has no "
                "session dataplane (set ServiceConfig.enable_si=True)")
        return self._sessions

    def open_session(self, side_img: np.ndarray,
                     session_id: Optional[str] = None) -> str:
        """Register a side image y; returns the session id. The whole
        request-invariant half of the search, paid once: pad y onto its
        bucket, build the SidePrep on this thread's stream, wait for it,
        and park it in the LRU/TTL store."""
        sessions = self._require_si()
        if not self._started:
            raise RuntimeError("start() before open_session()")
        if self._draining.is_set():
            self.metrics.counter("serve_rejected_drain").inc()
            raise ServiceDraining("service is draining; not accepting "
                                  "new sessions")
        img = np.asarray(side_img)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"expected (h, w, 3) side image, "
                             f"got {img.shape}")
        h, w = img.shape[:2]
        bucket = self.policy.bucket_for(h, w)
        padded = buckets_lib.pad_to_bucket(
            img.astype(np.float32, copy=False), bucket)
        bundle = self._swap.current
        t0 = time.monotonic()
        prep = bundle.server.open_session(padded)
        if self.device.type == "cuda":
            # the prep is complete before any worker stream may read it
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        self.metrics.histogram("serve_si_prep_ms").observe(
            (time.monotonic() - t0) * 1e3)
        sid = session_id if session_id is not None \
            else sessions.next_sid()
        # tracker registration BEFORE the store put: the store's evict hook
        # un-registers, and it only fires for sids the store holds
        self.quality.session_open(sid)
        try:
            sessions.put(session_lib.SessionEntry(
                sid=sid, prep=prep, bucket=bucket, nbytes=_prep_nbytes(prep),
                digest=bundle.digest))
        except BaseException:
            # refused (SessionOverCapacity): no evict hook will fire
            self.quality.session_gone(sid, "rejected")
            raise
        self.metrics.counter("serve_sessions_opened").inc()
        return sid

    def close_session(self, session_id: str) -> bool:
        """Free a session's prep; False if it was already gone."""
        return self._require_si().evict(session_id, "closed")

    def submit_decode_si(self, blob: bytes, session_id: str,
                         deadline_ms: Optional[float] = None,
                         priority: Optional[str] = None,
                         trace=None) -> Future:
        """Framed DSRV stream + open session -> Future[(h, w, 3) uint8
        SI-fused reconstruction]. A gone session raises typed
        `SessionExpired` here; one that expires between admission and
        batch start fails the batch's futures with the same type. The
        stream must route to the session's bucket."""
        sessions = self._require_si()
        payload, shape, bucket = self._stream_bucket(blob)
        entry = sessions.get(session_id)
        if entry.bucket != bucket:
            raise session_lib.SessionError(
                f"stream bucket {bucket} does not match session "
                f"{session_id!r} (opened at {entry.bucket}) — the SI "
                f"search needs x and y at one geometry; open a session "
                f"with a side image of the request's bucket")
        return self._submit(Request(
            key=(DECODE_SI, bucket), payload=(payload, shape,
                                              frame_crc(payload)),
            deadline=self._deadline(deadline_ms), priority=priority,
            session=session_id, trace=trace))

    def decode_si(self, blob: bytes, session_id: str,
                  deadline_ms: Optional[float] = None,
                  timeout: Optional[float] = 60.0,
                  priority: Optional[str] = None) -> np.ndarray:
        return self.submit_decode_si(blob, session_id, deadline_ms,
                                     priority=priority).result(timeout)

    def _resolve_session(self, batch, bundle) -> session_lib.SessionEntry:
        """Batch-start session lookup (worker side): the entry captured
        HERE is what the device stage reads — immutable, so a concurrent
        eviction cannot tear the search. A session that outlived its slot
        (LRU/TTL) or its model (a swap or rollback landed since its prep
        was built) fails the whole batch typed."""
        t0 = time.monotonic()
        entry = self._sessions.get(batch[0].session)
        if entry.digest != bundle.digest:
            self._sessions.evict(batch[0].session, "swap")
            raise session_lib.SessionExpired(
                f"session {batch[0].session!r} was prepared against "
                f"model {entry.digest} but {bundle.digest} is serving "
                f"(hot swap/rollback since) — re-open it")
        self.tracer.span_batch(batch, trace_lib.SPAN_SESSION, t0,
                               time.monotonic(),
                               session=batch[0].session)
        return entry

    def encode(self, img: np.ndarray, deadline_ms: Optional[float] = None,
               timeout: Optional[float] = 60.0,
               priority: Optional[str] = None) -> EncodeResult:
        return self.submit_encode(img, deadline_ms,
                                  priority=priority).result(timeout)

    def decode(self, blob: bytes, deadline_ms: Optional[float] = None,
               timeout: Optional[float] = 60.0,
               priority: Optional[str] = None) -> np.ndarray:
        return self.submit_decode(blob, deadline_ms,
                                  priority=priority).result(timeout)

    # -- worker side --------------------------------------------------------

    def _spawn_worker(self, slot: int) -> threading.Thread:
        t = threading.Thread(target=self._worker_main, args=(slot,),
                             name=f"serve-worker-{slot}", daemon=True)
        t.start()
        return t

    def _worker_main(self, slot: int) -> None:
        """Thread target: enter this thread's inference mode and CUDA
        stream (both are per-thread state), run the loop, and record a
        fatal exit for the supervisor."""
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.inference_mode())
                if self.device.type == "cuda":
                    stack.enter_context(torch.cuda.device(self.device))
                    stack.enter_context(torch.cuda.stream(
                        torch.cuda.Stream(self.device)))
                self._worker_loop()
        except BaseException as e:  # noqa: BLE001 — supervisor's evidence
            with self._workers_lock:
                self._worker_exits[slot] = e
            self.metrics.counter("serve_worker_crashes").inc()

    def _worker_loop(self) -> None:
        inflight: deque = deque()
        depth = max(1, int(self.config.pipeline_depth)) \
            if self._entropy_pool is not None else 1
        gauge = self.metrics.gauge("serve_pipeline_inflight")
        try:
            while True:
                # with work in flight, poll instead of blocking: an empty
                # queue means it is time to finish the oldest batch
                batch = self._batcher.next_batch(
                    timeout=0.0 if inflight else 0.25)
                if batch is None:
                    return        # closed and empty: finally flushes
                if batch:
                    t_start = time.monotonic()
                    try:
                        rec = self._start_batch(batch)
                    except BaseException as e:  # noqa: BLE001 — answer callers
                        for r in batch:
                            if not r.future.done():
                                r.future.set_exception(e)
                        if not isinstance(e, Exception):
                            # InjectedCrash-class conditions kill this
                            # thread so the supervisor sees the death
                            raise
                        continue
                    if rec is not None:
                        self._busy_ms.add((time.monotonic() - t_start) * 1e3)
                        self._track(inflight, rec)
                        gauge.set(len(inflight))
                elif not inflight:
                    continue
                # finish the oldest while the pipeline is full (one batch
                # when the queue is empty), unless the first class's work
                # is queued before that batch's entropy is done
                limit = depth if batch else len(inflight)
                while (len(inflight) >= limit
                       and self._oldest_first(inflight, depth)):
                    self._finish_oldest(inflight, gauge)
        finally:
            # no hung futures: whether this thread exits a drain or dies
            # between a batch's device launch and its entropy completion,
            # every in-flight record is completed or failed first
            while inflight:
                self._finish_oldest(inflight, gauge, swallow=True)
            gauge.set(0)

    def _track(self, inflight: deque, rec: _Inflight) -> None:
        """Queue a started batch for finishing: in start order, except that
        with priority classes a first-class batch goes ahead of every
        lower-class batch in flight (a decode's device stage runs at its
        finish)."""
        top = self._batcher.default_class
        if not self._priority_enabled or rec.batch[0].priority != top:
            inflight.append(rec)
            return
        k = 0
        while k < len(inflight) and inflight[k].batch[0].priority == top:
            k += 1
        inflight.insert(k, rec)

    def _oldest_first(self, inflight: deque, depth: int) -> bool:
        """The worker's one wait point before it finishes the oldest batch:
        True once that batch's entropy tasks are done. The express lane
        (priority classes only; the JAX worker has none): when the oldest
        batch is of a lower class and at most `depth` batches are in
        flight, False as soon as the first class has queued work, which the
        worker then starts at once (one batch over the depth at most),
        rather than wait behind that batch's entropy. The wait wakes on the
        tasks or on a first-class submit (`_wake_express`); the queue is
        read once a wake."""
        rec = inflight[0]
        top = self._batcher.default_class
        if (not self._priority_enabled or len(inflight) > depth
                or rec.batch[0].priority == top):
            return True
        while not all(t.done() for t in rec.tasks):
            arrival = PoolFuture()
            with self._express_lock:
                self._express_waiters.add(arrival)
            try:
                if self._batcher.class_depths().get(top, 0):
                    return False
                futures_wait([*rec.tasks, arrival],
                             return_when=FIRST_COMPLETED)
            finally:
                with self._express_lock:
                    self._express_waiters.discard(arrival)
        return True

    def _wake_express(self) -> None:
        """A first-class request was queued: wake every worker waiting in
        `_oldest_first`."""
        with self._express_lock:
            waiters, self._express_waiters = self._express_waiters, set()
        for w in waiters:
            w.set_result(None)

    def _finish_oldest(self, inflight: deque, gauge,
                       swallow: bool = False) -> None:
        rec = inflight.popleft()
        gauge.set(len(inflight))
        try:
            self._finish_batch(rec)
        except BaseException as e:  # noqa: BLE001 — must answer callers
            for r in rec.batch:
                if not r.future.done():
                    r.future.set_exception(e)
            if not isinstance(e, Exception) and not swallow:
                raise

    # -- supervision --------------------------------------------------------

    def _supervise_loop(self) -> None:
        """Restart dead workers with capped exponential backoff. Exits
        when the drain flag flips (dead workers stay dead during drain)."""
        while not self._draining.is_set():
            now = time.monotonic()
            live = 0
            with self._workers_lock:
                for i, t in enumerate(self._workers):
                    if t.is_alive():
                        live += 1
                        continue
                    if self._restart_at[i] is None:
                        # first observation of this death: schedule the
                        # restart after the slot's backoff, dump the ring
                        self._restart_at[i] = now + self._restart_policy \
                            .delay(self._restarts[i])
                        self.flight.note_death(
                            "worker_death", slot=i,
                            error=type(self._worker_exits.get(i)).__name__
                            if self._worker_exits.get(i) else None)
                    elif now >= self._restart_at[i]:
                        self._restarts[i] += 1
                        self._restart_at[i] = None
                        self._workers[i] = self._spawn_worker(i)
                        self.metrics.counter("serve_worker_restarts").inc()
                        self.flight.record("worker_restart", slot=i,
                                           restarts=self._restarts[i])
                        live += 1
            self.metrics.gauge("serve_workers_live").set(live)
            if self._watchdog is not None:
                self._watchdog_tick(now)
            self._draining.wait(self.config.supervise_every_s)
        self.metrics.gauge("serve_workers_live").set(self.live_workers)

    def _watchdog_tick(self, now: float) -> None:
        """One rollback-watchdog step on the supervisor thread: feed the
        counter sample, and when a verdict on the committed model fires,
        roll back CONDITIONALLY (`expect_current` pins the judged digest,
        so a watchdog racing an operator's rollback is refused typed and
        counted, never flipping the model back twice). The verdict is
        computed outside every lock; the rollback is a pointer swap."""
        errors, resolved = self._error_counters()
        self._watchdog.sample(now, errors, resolved)
        verdict = self._watchdog.evaluate(now, errors, resolved)
        if verdict is None:
            return
        self.flight.record("watchdog_verdict", **verdict)
        if not verdict["fire"]:
            return
        try:
            self.rollback(expect_current=verdict["digest"])
        except swap_lib.SwapError:
            # the judged model already left (an operator rollback or a
            # second swap won the race)
            self.metrics.counter("serve_watchdog_refused").inc()
            return
        self.metrics.counter("serve_watchdog_rollbacks").inc()
        self.flight.note_death("watchdog_rollback", **verdict)

    @property
    def _busy_ms(self) -> metrics_lib.Accumulator:
        """Wall time workers actually spent on batches (assemble +
        launch + finish); the busy input of serve_overlap_ratio."""
        return self.metrics.accumulator("serve_busy_ms_total")

    def _thread_codec(self, bundle: swap_lib.ModelBundle):
        """Entropy-stage codec for the CURRENT thread and the batch's
        bundle: a clone of the bundle's codec PER EPOCH (per-pass buffers
        stay thread-private; the clone shares the bundle codec's
        lock-guarded schedule cache). Keying by epoch is the swap's
        coherence: a thread coding an old-bundle batch keeps the old
        model's clone after the commit. Clones of retired epochs are pruned
        lazily against the coordinator's live set."""
        clones = getattr(self._codec_local, "clones", None)
        if clones is None:
            clones = self._codec_local.clones = {}
        codec = clones.get(bundle.epoch)
        if codec is None:
            codec = clones[bundle.epoch] = bundle.codec.thread_clone()
            if len(clones) > 3:
                live = set(self._swap.live_epochs())
                live.add(bundle.epoch)
                for e in [e for e in clones if e not in live]:
                    del clones[e]
        return codec

    def _device_encode(self, bundle, x: np.ndarray):
        """Launch the batched encode on this thread's stream -> (pinned
        host symbols, event or None)."""
        symbols = bundle.server.encode_symbols(_to_device(x, self.device))
        return _to_host(symbols)

    def _device_decode(self, bundle, sym: np.ndarray, si_entry):
        """The batched decode (the SI decode against `si_entry`'s prep) on
        this thread's stream -> (host images (N, H, W, 3) float32, waited
        for; the SI search's winning scores (N, P) on the host where the
        service asks for them, else None)."""
        sym_dev = _to_device(sym, self.device)
        scores = None
        if si_entry is None:
            imgs = bundle.server.decode(sym_dev)
        elif self._si_scores_enabled:
            imgs, scores = bundle.server.decode_si(sym_dev, si_entry.prep,
                                                   with_scores=True)
            scores = scores.cpu().numpy()
        else:
            imgs = bundle.server.decode_si(sym_dev, si_entry.prep)
        return _host_array(*_to_host(imgs)), scores

    def _note_encode_quality(self, bundle, batch, bucket, vols,
                             payloads) -> None:
        """Model-health telemetry of one encode batch, after its futures
        resolved, on the thread that coded it: the bpp export and the
        head-sampled coding-gap pass (never on the caller's latency)."""
        if not self.quality.enabled:
            return
        gap_codec = None
        for i, req in enumerate(batch):
            payload, exc = payloads[i]
            if exc is not None:
                continue
            self.quality.note_encode(bucket, req.payload[1], len(payload),
                                     len(payload) + _FRAME_LEN)
            if self.quality.sample_gap():
                if gap_codec is None:
                    gap_codec = self._thread_codec(bundle)
                self.quality.observe_gap(gap_codec, vols[i], payload, bucket)

    def _note_si_scores(self, batch, scores, failed) -> None:
        """Per-session SI-match summary of one SI batch, after its futures
        resolved; failed lanes decoded zeros, so their scores stay out."""
        if scores is None or not self.quality.enabled:
            return
        for i, r in enumerate(batch):
            if i not in failed:
                self.quality.note_si_scores(r.session, scores[i])

    def _start_batch(self, batch) -> Optional[_Inflight]:
        """Stage 1, on the worker thread. Serialized mode
        (entropy_workers=0) runs the whole batch here and returns None;
        pipelined mode launches the device stage / hands the entropy work
        to the pool and returns the in-flight record for _finish_batch."""
        faults.inject("serve.worker.batch")
        if self._batch_hook is not None:
            self._batch_hook(batch)
        kind, bucket = batch[0].key
        # ONE bundle read per batch: every stage below reads this capture
        bundle = self._swap.current
        t0 = time.monotonic()
        # batch formation is where queue wait ENDS
        if self.tracer.enabled:
            for r in batch:
                ctx = r.trace
                if ctx is not None and ctx.sampled:
                    self.tracer.record(trace_lib.SPAN_QUEUE, r.arrival,
                                       t0, [ctx.trace_id], cls=r.priority)
        self.flight.record("batch_seal", op=kind, bucket=list(bucket),
                           size=len(batch))
        self.metrics.gauge("serve_queue_depth").set(self._batcher.depth)
        self.metrics.histogram("serve_batch_occupancy").observe(
            len(batch) / self.config.max_batch)
        if self._entropy_pool is None:
            if kind == ENCODE:
                device_ms, entropy_ms = self._run_encode(batch, bucket,
                                                         bundle)
            else:
                device_ms, entropy_ms = self._run_decode(
                    batch, bucket, bundle, si=(kind == DECODE_SI))
            self._busy_ms.add((time.monotonic() - t0) * 1e3)
            self._note_batch_done(batch, t0, device_ms, entropy_ms,
                                  observe_latency=True)
            return None
        rec = _Inflight(kind, batch, bucket, t0, bundle)
        if kind == ENCODE:
            x = self._gather_images(batch, bucket)
            t_launch = time.monotonic()
            rec.handle = _DeviceBatch(*self._device_encode(bundle, x),
                                      t_launch)
        else:
            if kind == DECODE_SI:
                # resolve the session BEFORE any entropy work is queued:
                # a gone session fails the batch typed here
                rec.si_entry = self._resolve_session(batch, bundle)
            rec.sym = self._empty_symbols(bucket)
        # ONE pool task per micro-batch: per-request isolation lives
        # INSIDE the task
        rec.tasks = [self._entropy_pool.submit(self._entropy_batch_task,
                                               rec)]
        return rec

    def _gather_images(self, batch, bucket) -> np.ndarray:
        """The padded (max_batch, bh, bw, 3) encode batch: requests in
        order, zero lanes after them."""
        bh, bw = bucket
        x = np.zeros((self.config.max_batch, bh, bw, 3), np.float32)
        for i, r in enumerate(batch):
            x[i] = r.payload[0]
        return x

    def _empty_symbols(self, bucket) -> np.ndarray:
        bh, bw = bucket
        sub = buckets_lib.SUBSAMPLING
        return np.zeros((self.config.max_batch, bh // sub, bw // sub,
                         self._bn_channels), np.int32)

    def _item_failed(self, rec: _Inflight, i: int, req,
                     e: BaseException) -> None:
        """Record + answer one request's entropy-stage failure (an
        IntegrityError lands on that request's future only; a
        non-`Exception` crash is recorded for _finish_batch to re-raise on
        the worker thread)."""
        rec.per_item_exc[i] = e
        if not req.future.done():
            req.future.set_exception(e)
            self._observe_latency(req)
        if isinstance(e, IntegrityError):
            self.metrics.counter("serve_integrity_errors").inc()
        if not isinstance(e, Exception):
            rec.crash = e

    # -- the process entropy backend -------------------------------------------

    def _entropy_lane_bytes(self) -> int:
        """Payload bound for ONE task or reply lane: a whole micro-batch of
        the largest bucket's int32 symbol volumes, plus pickle slack.
        Oversize falls back inline by the lane contract, so this sizes the
        lanes; it guarantees nothing."""
        vol = max((d * h * w for (d, h, w) in self._warm_shapes),
                  default=128 * 1024)
        return self.config.max_batch * vol * 4 + 65536

    def _make_entropy_proc(self, initargs) -> _EntropyPool:
        """A fresh process pool for one bundle's CodecSpec, spawned (never
        forked: the parent holds a CUDA context). Its children rebuild the
        codec once in the initializer and warm every bucket's schedule.
        With transport="shm" each pool generation gets its own lane ring
        (task and reply lanes, 2 per batch in flight, plus spares) whose
        manifest rides the initializer; the ring is unlinked with the
        pool."""
        rings = None
        manifest = None
        lane_bytes = self._entropy_lane_bytes()
        if self.config.transport == "shm":
            n_lanes = 2 * max(2, self._entropy_workers
                              * max(1, self.config.pipeline_depth)) + 2
            classes = shmlane_lib.derive_lane_classes([("ent", lane_bytes)],
                                                      n_lanes)
            need = sum(c.lane_bytes * c.n_lanes for c in classes)
            try:
                st = os.statvfs("/dev/shm")
                free = st.f_bavail * st.f_frsize
            except OSError:
                free = None
            if free is not None and need > free:
                # a lane written past the segment's backing store would
                # kill the process with SIGBUS; refuse typed instead
                raise RuntimeError(
                    f"transport='shm' needs {need} bytes of /dev/shm for "
                    f"{n_lanes} lanes of {classes[0].lane_bytes} B; "
                    f"{free} are free")
            rings = shmlane_lib.LaneRing.create("ent", classes,
                                                metrics=self.metrics)
            manifest = rings.manifest()
        pool = ProcessPoolExecutor(
            max_workers=self._entropy_workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=loader_lib.init_worker_codec,
            initargs=tuple(initargs) + (manifest,))
        return _EntropyPool(pool, rings, lane_bytes)

    def _proc_call(self, bundle, fn, *args, timeout: Optional[float] = None):
        """One coding task on the process backend, surviving child death: a
        child that is killed marks the whole pool broken (every later
        submit raises BrokenProcessPool), so the first bridge thread to see
        it swaps in a fresh pool and the task is retried once on it. A
        second break propagates and fails this batch typed; the next batch
        again finds a fresh pool. A child that HANGS never breaks the pool,
        so the wait is bounded by `timeout` (default
        `entropy_proc_timeout_s`): on expiry the wedged pool is replaced,
        its children killed, and the batch fails with TimeoutError, not
        retried. A submit that loses a swap race (another bridge thread
        shut the pool down between our read and the submit: a bare
        RuntimeError) is retried too: nothing ran in a child. No lock is
        held across the wait."""
        timeout = self.config.entropy_proc_timeout_s \
            if timeout is None else timeout
        last_exc = None
        for _ in (0, 1):
            proc = bundle.proc()
            if proc is None:
                raise RuntimeError(
                    f"entropy pool of model bundle epoch {bundle.epoch} "
                    f"was retired while this batch was in flight")
            try:
                # lanes per ATTEMPT on the current generation's ring: a
                # retry must not name the dead generation's segment
                fut, refs = self._submit_entropy(proc, fn, args)
            except RuntimeError as e:
                if (not isinstance(e, BrokenProcessPool)
                        and "cannot schedule new futures" not in str(e)):
                    raise
                self._swap_entropy_proc(bundle, proc)
                last_exc = e
                continue
            try:
                out = fut.result(timeout)
                # resolved BEFORE the finally frees the reply lane
                return self._resolve_entropy(proc, out)
            except BrokenProcessPool as e:
                self._swap_entropy_proc(bundle, proc)
                last_exc = e
                continue
            except FutureTimeout:
                self._swap_entropy_proc(bundle, proc, kill=True)
                raise TimeoutError(
                    f"entropy process backend task exceeded {timeout}s "
                    f"(child alive but stuck); pool replaced") from None
            finally:
                # the parent reclaims task and reply lanes once the future
                # settled, whatever happened (a no-op after a swap
                # unlinked the ring)
                self._release_entropy(proc, refs)
        raise last_exc

    def _submit_entropy(self, proc: _EntropyPool, fn, args):
        """Submit one coding task -> (future, (task_ref, reply_ref)). Pipe
        transport submits as is. shm transport lanes the payload (args[0])
        when it is big enough and a lane is free (inline otherwise,
        counted by the ring) and claims a reply lane for the child to
        write the result into."""
        if proc.rings is None:
            return proc.submit(fn, *args), (None, None)
        payload, rest = args[0], args[1:]
        task_ref = proc.rings.put_obj(payload)
        reply_ref = proc.rings.claim(proc.reply_bytes)
        try:
            fut = proc.submit(fn, payload if task_ref is None else task_ref,
                              *rest, reply=reply_ref)
        except BaseException:
            self._release_entropy(proc, (task_ref, reply_ref))
            raise
        return fut, (task_ref, reply_ref)

    def _resolve_entropy(self, proc: _EntropyPool, out):
        """A LaneRef result is copied out of the reply lane, CRC-verified
        (corruption raises IntegrityError and fails the batch, never wrong
        symbols) and counted in `serve_shm_replies` (the child's ring
        counts nothing); free=False: `_proc_call`'s finally owns the
        reclaim."""
        if not isinstance(out, shmlane_lib.LaneRef):
            return out
        self.metrics.counter("serve_shm_replies").inc()
        return proc.rings.take_obj(out, free=False)

    @staticmethod
    def _release_entropy(proc: _EntropyPool, refs) -> None:
        if proc.rings is None:
            return
        for ref in refs:
            if ref is not None:
                proc.rings.free(ref)

    def _swap_entropy_proc(self, bundle, seen: _EntropyPool,
                           kill: bool = False) -> None:
        """Replace a bundle's broken or wedged pool with a fresh one built
        from ITS OWN CodecSpec (the first bridge thread to report `seen`
        swaps; the rest find it done) and abandon the old one without
        waiting on its children; `kill` terminates them."""
        if bundle.swap_proc_if(
                seen, lambda: self._make_entropy_proc(bundle.proc_initargs)):
            self.metrics.counter("serve_entropy_proc_rebuilds").inc()
            self.flight.record("entropy_proc_rebuild", epoch=bundle.epoch,
                               killed=kill)
        seen.shutdown(wait=False, kill=kill)         # idempotent

    def _encode_vols(self, bundle, vols, trace=None) -> list:
        """N (D, H, W) symbol volumes -> [(payload, None) | (None, exc)]
        per lane, one batch call on the bundle's backend, always against
        the BATCH's bundle. On the process backend each volume is first
        copied into memory of its own: the pool pickles a task after
        `submit` returns, and the task must not read the batch's host
        buffer. `trace` (sampled contexts) rides the task and comes back
        as a checked echo with the child's coding span."""
        if bundle.proc_initargs is None:
            return loader_lib.encode_batch_isolated(
                self._thread_codec(bundle), vols)
        vols = [np.array(v, order="C") for v in vols]
        out = self._proc_call(bundle, loader_lib.worker_encode_batch, vols,
                              trace)
        if trace is not None:
            out, echo = out
            self._note_proc_echo(trace, echo)
        return out

    def _decode_payloads(self, bundle, payloads, trace=None) -> list:
        """N DTPC payloads -> [(volume, None) | (None, exc)] per lane. On
        the process backend the mode-2 lanes go to the pool in one task;
        a lane in any other mode (a client's mode-3 stream) is decoded on
        this bridge thread through the bundle's codec, K3 on the card, as
        the thread backend decodes it, and a lane whose header does not
        parse fails here with the codec's own error."""
        codec = self._thread_codec(bundle)
        if bundle.proc_initargs is None:
            return loader_lib.decode_batch_isolated(codec, payloads)
        out = [None] * len(payloads)
        pool_idx, local_idx = [], []
        for i, blob in enumerate(payloads):
            try:
                mode_id, _ = codec._parse_header(blob)
            except ValueError as exc:
                out[i] = (None, exc)
                continue
            (pool_idx if mode_id == MODE_WAVEFRONT_NP
             else local_idx).append(i)
        if local_idx:
            for i, lane in zip(local_idx, loader_lib.decode_batch_isolated(
                    codec, [payloads[i] for i in local_idx])):
                out[i] = lane
        if pool_idx:
            got = self._proc_call(bundle, loader_lib.worker_decode_batch,
                                  [payloads[i] for i in pool_idx], trace)
            if trace is not None:
                got, echo = got
                self._note_proc_echo(trace, echo)
            for i, lane in zip(pool_idx, got):
                out[i] = lane
        return out

    def _note_proc_echo(self, sent, echo: dict) -> None:
        """Check the trace contexts that rode a pool task against what came
        back (serialization must be lossless for ids to stitch) and record
        the child's coding span (its pid and coding_ms, ending at the
        bridge's receive)."""
        if tuple(echo.get("trace") or ()) != tuple(sent):
            # a mangled context cannot corrupt results (the lanes ride
            # separately) but it breaks stitching: count it
            self.metrics.counter("serve_trace_proc_mismatch").inc()
            return
        t1 = time.monotonic()
        t0 = t1 - echo.get("coding_ms", 0.0) / 1e3
        self.tracer.record(trace_lib.SPAN_ENTROPY_PROC, t0, t1,
                           [c.trace_id for c in sent], pid=echo.get("pid"))

    def _encode_results(self, batch, bucket, bundle, payloads, fail) -> None:
        """Frame each lane's payload and resolve its future; a lane's
        coding error goes to `fail(i, req, exc)` only."""
        for i, req in enumerate(batch):
            payload, exc = payloads[i]
            if exc is not None:
                fail(i, req, exc)
                continue
            h, w = req.payload[1]
            req.future.set_result(EncodeResult(
                stream=frame_stream(payload, (h, w), bucket),
                payload_bytes=len(payload),
                bpp=len(payload) * 8.0 / (h * w),
                shape=(h, w), bucket=bucket,
                model_digest=bundle.digest))

    def _decode_batch_lanes(self, batch, sym, decode, fail) -> None:
        """One micro-batch's decode-side entropy work under the
        per-request fault contract, shared by the pipelined task and the
        serialized path: the `serve.rans` fault site + payload-CRC
        re-verify run per lane on this thread, the decode (`decode(
        payloads) -> [(vol, exc)]`, either backend) isolates structural
        errors per lane, and the sym write itself is guarded per lane — a
        CRC-valid stream whose DTPC header lies about the bucket geometry
        fails only ITS request. `fail(i, req, exc)` records one lane's
        failure."""
        good, payloads = [], []
        for i, req in enumerate(batch):
            try:
                data = faults.corrupt("serve.rans", req.payload[0])
                verify_crc(req.payload[2], "DSRV payload (worker)", data)
            except BaseException as e:  # noqa: BLE001 — isolate lanes
                fail(i, req, e)
            else:
                good.append(i)
                payloads.append(data)
        if not good:
            return
        for i, (vol, exc) in zip(good, decode(payloads)):
            if exc is None:
                # EXPLICIT shape check: numpy would BROADCAST a compatible
                # wrong geometry into the slot
                h, w, c = sym[i].shape          # want vol = (C, h, w)
                if tuple(vol.shape) == (c, h, w):
                    sym[i] = np.transpose(vol, (1, 2, 0))
                    continue
                exc = ValueError(
                    f"decoded volume {tuple(vol.shape)} does not fit "
                    f"the bucket slot {sym[i].shape}")
            fail(i, batch[i], exc)

    def _entropy_batch_task(self, rec: _Inflight) -> tuple:
        """Stage 2, ONE entropy-pool task per micro-batch. Encode futures
        resolve here the moment their frame is built. Never raises: a
        non-`Exception` (InjectedCrash class) is recorded on the record and
        re-raised by _finish_batch on the worker thread. Returns the
        (start, end) entropy span."""
        te0 = te1 = None
        fail = lambda i, req, e: self._item_failed(rec, i, req, e)  # noqa: E731
        try:
            trace = self.tracer.sampled_tuple(rec.batch) \
                if rec.bundle.proc_initargs is not None else None
            if rec.kind == ENCODE:
                symbols = rec.handle.host()   # waits on this batch's copy
                self.tracer.span_batch(
                    rec.batch, trace_lib.SPAN_DEVICE,
                    rec.handle.dispatched, rec.handle.transfer_done,
                    kind=rec.kind, bucket=list(rec.bucket))
                te0 = time.monotonic()
                vols = [np.transpose(symbols[i], (2, 0, 1))
                        for i in range(len(rec.batch))]
                payloads = self._encode_vols(rec.bundle, vols, trace)
                te1 = time.monotonic()
                self._encode_results(rec.batch, rec.bucket, rec.bundle,
                                     payloads, fail)
                for i, req in enumerate(rec.batch):
                    if i not in rec.per_item_exc:
                        self._observe_latency(req)
                self._note_encode_quality(rec.bundle, rec.batch, rec.bucket,
                                          vols, payloads)
            else:
                te0 = time.monotonic()
                self._decode_batch_lanes(
                    rec.batch, rec.sym,
                    lambda p: self._decode_payloads(rec.bundle, p, trace),
                    fail)
                te1 = time.monotonic()
        except BaseException as e:  # noqa: BLE001 — answer every caller
            for i, req in enumerate(rec.batch):
                if i not in rec.per_item_exc and not req.future.done():
                    self._item_failed(rec, i, req, e)
            if not isinstance(e, Exception):
                rec.crash = e
        if te0 is not None and te1 is not None:
            self.metrics.histogram("serve_entropy_batch_ms").observe(
                (te1 - te0) * 1e3)
            self.tracer.span_batch(rec.batch, trace_lib.SPAN_ENTROPY,
                                   te0, te1, kind=rec.kind,
                                   backend=self.config.entropy_backend)
        return (te0, te1)

    def _finish_batch(self, rec: _Inflight) -> None:
        """Stage 3, back on the worker thread: wait for the record's
        entropy tasks, run the decode device stage, publish the batch
        metrics, then surface a recorded crash."""
        tf0 = time.monotonic()
        spans = [t.result() for t in rec.tasks]   # tasks never raise
        device_ms = 0.0
        if rec.kind == ENCODE:
            device_ms = rec.handle.device_ms
        elif len(rec.per_item_exc) == len(rec.batch):
            # every item already failed (CRC/decode): skip the device call
            self.metrics.counter("serve_device_skipped_batches").inc()
        else:
            t_dev = time.monotonic()
            imgs, scores = self._device_decode(rec.bundle, rec.sym,
                                               rec.si_entry)
            t_dev_end = time.monotonic()
            device_ms = (t_dev_end - t_dev) * 1e3
            self._note_device_span(rec.batch, rec.kind, rec.bucket, t_dev,
                                   t_dev_end)
            for i, r in enumerate(rec.batch):
                if i in rec.per_item_exc:
                    continue       # its future already holds the error
                h, w = r.payload[1]
                r.future.set_result(
                    buckets_lib.crop_from_bucket(imgs[i], (h, w))
                    .astype(np.uint8))
                self._observe_latency(r)
            self._note_si_scores(rec.batch, scores, rec.per_item_exc)
        starts = [s[0] for s in spans if s[0] is not None]
        ends = [s[1] for s in spans if s[1] is not None]
        entropy_ms = (max(ends) - min(starts)) * 1e3 \
            if starts and ends else 0.0
        self._busy_ms.add((time.monotonic() - tf0) * 1e3)
        self._note_batch_done(rec.batch, rec.t0, device_ms, entropy_ms)
        if rec.crash is not None:
            raise rec.crash

    def _note_device_span(self, batch, kind, bucket, t0, t1) -> None:
        self.tracer.span_batch(batch, trace_lib.SPAN_DEVICE, t0, t1,
                               kind=kind, bucket=list(bucket))
        if kind == DECODE_SI:
            # the SI device stage IS the decode -> search -> siNet path
            self.metrics.histogram("serve_si_search_ms").observe(
                (t1 - t0) * 1e3)
            self.tracer.span_batch(batch, trace_lib.SPAN_SI_SEARCH, t0, t1,
                                   session=batch[0].session)

    def _observe_latency(self, req) -> None:
        """Arrival -> future-RESOLUTION latency, recorded the moment the
        request's future is set; with priority classes also per class
        (`serve_latency_ms_<cls>`, the p99 the front-door leg gates)."""
        ms = (time.monotonic() - req.arrival) * 1e3
        self.metrics.histogram("serve_latency_ms").observe(ms)
        if self._priority_enabled and req.priority is not None:
            self.metrics.histogram(
                f"serve_latency_ms_{req.priority}").observe(ms)

    def _note_batch_done(self, batch, t0, device_ms, entropy_ms,
                         observe_latency: bool = False) -> None:
        now = time.monotonic()
        if observe_latency:
            # serialized path: futures resolved moments ago in _run_*
            for r in batch:
                self._observe_latency(r)
        kind, bucket = batch[0].key
        self.metrics.counter(
            f"serve_bucket_requests_{bucket[0]}x{bucket[1]}").inc(len(batch))
        self.metrics.counter("serve_device_batches_d0").inc()
        self.metrics.counter("serve_batches").inc()
        self.metrics.counter("serve_completed").inc(len(batch))
        self.metrics.histogram("serve_batch_ms").observe((now - t0) * 1e3)
        for name, ms in (("serve_device_ms", device_ms),
                         ("serve_entropy_ms", entropy_ms)):
            self.metrics.histogram(name).observe(ms)
            self.metrics.histogram(f"{name}_{kind}").observe(ms)
            self.metrics.accumulator(f"{name}_total").add(ms)
        self.metrics.gauge("serve_native_builds").set(
            native_build.build_count())
        self._publish_launches()
        self._update_overlap_gauge()

    def _publish_launches(self) -> None:
        """This process's kernel launches (`sk.launch_counts`, counted by
        each wrapper where it launches) as `serve_kernel_launches_<name>`
        gauges, and the launches and native builds as info entries, which
        a front door's AggregatedMetrics carries per replica."""
        counts = dict(sk.launch_counts)
        for name, n in counts.items():
            self.metrics.gauge(f"serve_kernel_launches_{name}").set(n)
        self.metrics.set_info("serve_kernel_launches", counts)
        self.metrics.set_info("serve_native_builds",
                              native_build.build_count())

    def _update_overlap_gauge(self) -> None:
        """serve_overlap_ratio = 1 - busy/(device+entropy): 0 when the
        stages run strictly serialized on the worker, approaching
        1 - max/sum as the pipeline hides one stage behind the other.
        Clamped at 0."""
        dev = self.metrics.accumulator("serve_device_ms_total").value
        ent = self.metrics.accumulator("serve_entropy_ms_total").value
        busy = self._busy_ms.value
        if dev + ent > 0:
            self.metrics.gauge("serve_overlap_ratio").set(
                max(0.0, 1.0 - busy / (dev + ent)))

    def _run_encode(self, batch, bucket, bundle) -> Tuple[float, float]:
        """Serialized encode (entropy_workers=0): device then entropy,
        inline on the worker thread. Returns (device_ms, entropy_ms)."""
        x = self._gather_images(batch, bucket)
        t_dev = time.monotonic()
        symbols = _host_array(*self._device_encode(bundle, x))
        t_ent = time.monotonic()
        vols = [np.transpose(symbols[i], (2, 0, 1))
                for i in range(len(batch))]
        payloads = self._encode_vols(bundle, vols)
        self._encode_results(batch, bucket, bundle, payloads,
                             lambda i, r, e: r.future.set_exception(e))
        t_done = time.monotonic()
        self._note_encode_quality(bundle, batch, bucket, vols, payloads)
        self.tracer.span_batch(batch, trace_lib.SPAN_DEVICE, t_dev,
                               t_ent, kind=ENCODE, bucket=list(bucket))
        self.tracer.span_batch(batch, trace_lib.SPAN_ENTROPY, t_ent,
                               t_done, kind=ENCODE, backend="inline")
        return ((t_ent - t_dev) * 1e3, (t_done - t_ent) * 1e3)

    def _run_decode(self, batch, bucket, bundle,
                    si: bool = False) -> Tuple[float, float]:
        """Serialized decode (entropy_workers=0): entropy then device,
        inline on the worker thread. Returns (device_ms, entropy_ms).
        With `si` the session is resolved FIRST — a gone session fails the
        batch typed before any entropy work."""
        si_entry = self._resolve_session(batch, bundle) if si else None
        sym = self._empty_symbols(bucket)
        per_item_exc = {}
        t_ent = time.monotonic()

        def _fail(i, r, e):
            if not isinstance(e, Exception):
                raise e   # worker-killing injected crash
            per_item_exc[i] = e
            if isinstance(e, IntegrityError):
                self.metrics.counter("serve_integrity_errors").inc()

        self._decode_batch_lanes(
            batch, sym, lambda p: self._decode_payloads(bundle, p), _fail)
        t_ent_end = time.monotonic()
        entropy_ms = (t_ent_end - t_ent) * 1e3
        self.tracer.span_batch(batch, trace_lib.SPAN_ENTROPY, t_ent,
                               t_ent_end, kind=batch[0].key[0],
                               backend="inline")
        if len(per_item_exc) == len(batch):
            for i, r in enumerate(batch):
                r.future.set_exception(per_item_exc[i])
            self.metrics.counter("serve_device_skipped_batches").inc()
            return (0.0, entropy_ms)
        t_dev = time.monotonic()
        imgs, scores = self._device_decode(bundle, sym, si_entry)
        t_dev_end = time.monotonic()
        self._note_device_span(batch, batch[0].key[0], bucket, t_dev,
                               t_dev_end)
        for i, r in enumerate(batch):
            if i in per_item_exc:
                r.future.set_exception(per_item_exc[i])
                continue
            h, w = r.payload[1]
            r.future.set_result(
                buckets_lib.crop_from_bucket(imgs[i], (h, w))
                .astype(np.uint8))
        self._note_si_scores(batch, scores, per_item_exc)
        return ((t_dev_end - t_dev) * 1e3, entropy_ms)
