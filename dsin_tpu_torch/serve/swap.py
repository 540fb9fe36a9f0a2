"""Live model hot swap: versioned bundles, instant rollback, the post-commit
watchdog (a copy of the JAX package's `serve/swap.py`).

A running `CompressionService` (serve/service.py) adopts a retrained
checkpoint without dropping a request and rolls back in milliseconds when
the new model misbehaves. "The model" is several coupled things the
dataplane reads at different moments: the device weights of the batched
device functions (`DeviceServer`), the codec's context-model weights on the
host, the per-thread codec clones of the entropy pool, and with the process
entropy backend a pool of children that hold their own codec. A swap that
changed them one by one would give TORN batches (device stage on model A,
entropy stage on model B: a stream no model decodes). This module makes
the whole set one value:

* **ModelBundle**: one model version, whole: its `DeviceServer`s (one per
  logical serve device, each with its own copy of the weights: the JAX
  bundle's `device_state` list), codec, digest, manifest, and (process
  backend) its OWN pool of children built from its own `CodecSpec` file. A worker captures ONE bundle at batch
  start and threads it through every stage, so a batch is coherent
  whenever the swap lands; in-flight batches finish on the bundle they
  started with.

* **SwapCoordinator**: the three-slot state machine under one lock:
  `current` (serving), `staged` (loaded and warmed by a prepare, waiting
  for its commit), `prev` (the last served bundle, kept warm for an
  instant rollback). Transitions are pointer swaps under the lock, and
  every displaced bundle is handed back to the caller, who retires it
  OUTSIDE the lock (a pool shutdown joins processes). Counters and gauge:
  `serve_swaps`, `serve_rollbacks`, `serve_swap_errors`,
  `serve_swap_state` (0 idle / 1 preparing / 2 staged), and the
  `serve_model_digest` info entry (current, prev and staged digests and
  the checkpoint path) every scrape carries.

* **RollbackWatchdog**: the post-commit judge: typed-error rates before
  and after a commit, and the golden canary's verdict on the committed
  digest.

The coordinator never builds or warms bundles: the service does, on the
CALLER's thread while the dataplane keeps serving.
"""

from __future__ import annotations

import shutil
import threading
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

#: serve_swap_state gauge values
SWAP_IDLE = 0
SWAP_PREPARING = 1
SWAP_STAGED = 2


class SwapError(RuntimeError):
    """A hot-swap transition was refused (no staged bundle to commit,
    nothing to roll back to, digest disagreement at commit, a second
    swap while one is in flight). The service keeps serving its current
    bundle — a refused swap is an operator error, never an outage."""


class ConditionalRollbackRefused(SwapError):
    """A CONDITIONAL rollback (`expect_current=`) found the service
    already serving a different digest — this replica never committed
    the model being rolled away, so refusing is CONVERGENCE, not
    failure. Typed as its own class so fleet- and
    federation-tier callers can classify the refusal structurally; the
    message keeps the historical "conditional rollback refused" stem
    callers already string-match across the replica pipe."""


class ModelBundle:
    """One model version, whole: the `DeviceServer`s (`servers`, one per
    logical serve device, each holding its own copy of the weights;
    `server` is device 0's, where the canary and sessions run), the host
    codec, the digest that names them (the JAX package's
    `params_digest` of the served weights), the checkpoint they came from
    and its manifest (the canary reads its goldens). Immutable after
    construction except the process entropy backend's pool slot, which a
    child-death rebuild swaps under the slot's lock; `proc_initargs` (the
    pool initializer's arguments: the path of the pickled `CodecSpec` and
    the warm shapes) is None on the thread backend. `spec_dir`, when
    given, is the directory of this bundle's spec file, removed by
    `retire` (or when the bundle is collected). `epoch` increases across
    the bundles of one service; a rollback re-instates an OLD epoch rather
    than minting one."""

    __slots__ = ("epoch", "digest", "ckpt", "server", "servers", "codec",
                 "proc_initargs", "manifest", "_spec_cleanup", "_proc",
                 "_proc_lock", "__weakref__")

    def __init__(self, epoch: int, digest: str, server, codec, *,
                 ckpt: Optional[str] = None, proc_initargs=None,
                 manifest: Optional[Dict[str, Any]] = None,
                 spec_dir: Optional[str] = None,
                 servers: Optional[Sequence] = None):
        self.epoch = int(epoch)
        self.digest = digest
        self.ckpt = ckpt
        self.servers = tuple(servers) if servers else (server,)
        self.server = self.servers[0]
        self.codec = codec
        self.proc_initargs = proc_initargs
        self.manifest = manifest
        self._spec_cleanup = (None if spec_dir is None else weakref.finalize(
            self, shutil.rmtree, spec_dir, True))
        self._proc_lock = threading.Lock()
        self._proc = None              # guarded-by: self._proc_lock

    # -- process-backend pool slot -------------------------------------------

    def proc(self):
        with self._proc_lock:
            return self._proc

    def set_proc(self, pool) -> None:
        with self._proc_lock:
            self._proc = pool

    def swap_proc_if(self, seen, factory) -> bool:
        """Child-death rebuild: the first bridge thread to report `seen`
        swaps in `factory()`; later reporters find it already replaced.
        The factory runs under the slot lock: it only constructs an
        executor (children spawn lazily at the first submit)."""
        with self._proc_lock:
            if self._proc is not seen:
                return False
            self._proc = factory()
        return True

    def retire(self) -> None:
        """Release what this bundle alone owns: shut its process pool down
        (its lane ring unlinked with it) and remove its spec file.
        Idempotent; called OUTSIDE the coordinator's lock. The pool's
        submitted tasks finish and its children are joined (reaped) before
        it returns, so it blocks for seconds on the process backend (the
        JAX package's `retire` returns without joining; the service retires
        a commit's displaced bundle on a thread of its own); a batch that
        captured this bundle and submits after the retire fails typed."""
        with self._proc_lock:
            pool, self._proc = self._proc, None
        if pool is not None:
            pool.shutdown(wait=True)
        if self._spec_cleanup is not None:
            self._spec_cleanup()

    def __repr__(self) -> str:
        return (f"ModelBundle(epoch={self.epoch}, digest={self.digest!r}, "
                f"ckpt={self.ckpt!r})")


class SwapCoordinator:
    """current/staged/prev bundle slots + the transition rules.

    All methods are O(pointer swap) under one lock; displaced
    bundles come back in the returned list for the caller to retire
    outside the lock. Exactly one prepare may be in flight (`begin_
    prepare` claims, `stage`/`abandon_prepare` releases) — a second
    swapper is refused typed, mirroring the rebalance claim flag.
    """

    def __init__(self, current: ModelBundle, metrics):
        self._lock = threading.Lock()
        self._current = current            # guarded-by: self._lock
        self._prev: Optional[ModelBundle] = None     # guarded-by: self._lock
        self._staged: Optional[ModelBundle] = None   # guarded-by: self._lock
        self._preparing = False            # guarded-by: self._lock
        self._next_epoch = current.epoch + 1         # guarded-by: self._lock
        # abort() during an IN-FLIGHT prepare cannot release the claim
        # (the preparing thread owns it) — it instead cancels every
        # epoch claimed so far; that prepare's stage() is then refused
        # typed and its own cleanup releases the claim. Without this, a
        # fleet abort racing a slow replica prepare would let the late
        # stage park a bundle nobody will ever commit or abort again.
        self._cancelled_before = 0         # guarded-by: self._lock
        self.metrics = metrics
        with self._lock:
            snap = self._snapshot_locked()
        self._publish_locked_out(snap)

    # -- reads ---------------------------------------------------------------

    @property
    def current(self) -> ModelBundle:
        with self._lock:
            return self._current

    @property
    def staged(self) -> Optional[ModelBundle]:
        """The prepared-but-uncommitted bundle, if any — the canary
        goldens publisher (serve/service.py `canary_goldens(staged=
        True)`) probes it to record what an incoming model SHOULD
        produce before anyone commits it."""
        with self._lock:
            return self._staged

    def live_epochs(self) -> List[int]:
        """Epochs a dataplane thread may still legitimately touch —
        the thread-local codec-clone caches prune against this."""
        with self._lock:
            return [b.epoch for b in (self._current, self._prev,
                                      self._staged) if b is not None]

    def all_bundles(self) -> List[ModelBundle]:
        with self._lock:
            return [b for b in (self._current, self._prev, self._staged)
                    if b is not None]

    def _snapshot_locked(self) -> Dict[str, Any]:
        swap_state = (SWAP_STAGED if self._staged is not None
                      else SWAP_PREPARING if self._preparing else SWAP_IDLE)
        return {
            "digest": self._current.digest,
            "epoch": self._current.epoch,
            "ckpt": self._current.ckpt,
            "prev_digest": self._prev.digest if self._prev else None,
            "staged_digest": self._staged.digest if self._staged else None,
            "swap_state": swap_state,
        }

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return self._snapshot_locked()

    def _publish_locked_out(self, snap: Dict[str, Any]) -> None:
        """Export the transition to /metrics — called with the snapshot
        already taken, AFTER the lock is released (metric locks are leaf
        rungs, but keeping the swap lock's hold time at pointer-swap
        cost is the contract)."""
        self.metrics.gauge("serve_swap_state").set(snap["swap_state"])
        self.metrics.set_info("serve_model_digest", snap)

    def _publish(self) -> None:
        with self._lock:
            snap = self._snapshot_locked()
        self._publish_locked_out(snap)

    # -- transitions ---------------------------------------------------------

    def begin_prepare(self) -> int:
        """Claim the single prepare slot; returns the epoch the incoming
        bundle must carry. Refused typed while another prepare runs or a
        staged bundle awaits its commit/abort."""
        with self._lock:
            if self._preparing:
                raise SwapError("a model swap is already preparing — one "
                                "swap at a time")
            if self._staged is not None:
                raise SwapError(
                    f"a prepared bundle (digest "
                    f"{self._staged.digest!r}) is already staged — "
                    f"commit or abort it before preparing another")
            self._preparing = True
            epoch = self._next_epoch
            self._next_epoch += 1
        self._publish()
        return epoch

    def abandon_prepare(self) -> None:
        """Release the prepare claim after a failed load/warm (the
        error path; the bundle never staged)."""
        with self._lock:
            self._preparing = False
        self.metrics.counter("serve_swap_errors").inc()
        self._publish()

    def stage(self, bundle: ModelBundle) -> None:
        """Prepared bundle parked, awaiting commit. The prepare claim
        converts into the staged slot — unless an abort() landed while
        the prepare was loading, in which case staging is refused typed
        (the preparer's cleanup retires the bundle and releases the
        claim)."""
        with self._lock:
            if not self._preparing:
                raise SwapError("stage() without begin_prepare()")
            if bundle.epoch < self._cancelled_before:
                raise SwapError(
                    f"swap prepare (epoch {bundle.epoch}) was aborted "
                    f"while it was still loading — not staging it")
            self._preparing = False
            self._staged = bundle
        self._publish()

    def commit(self, expect_digest: Optional[str] = None
               ) -> List[ModelBundle]:
        """staged -> current, current -> prev; returns displaced bundles
        (the old prev) for retirement. Instant: every expensive thing
        happened at prepare. `expect_digest` pins WHICH model the caller
        believes it is committing (the fleet two-phase contract)."""
        with self._lock:
            staged = self._staged
            if staged is None:
                raise SwapError("no staged bundle to commit — prepare "
                                "first")
            if expect_digest is not None and staged.digest != expect_digest:
                raise SwapError(
                    f"staged bundle digest {staged.digest!r} is not the "
                    f"expected {expect_digest!r} — refusing to commit a "
                    f"model the caller did not verify")
            displaced = [b for b in (self._prev,) if b is not None]
            self._staged = None
            self._prev = self._current
            self._current = staged
            snap = self._snapshot_locked()
        self.metrics.counter("serve_swaps").inc()
        self._publish_locked_out(snap)
        return displaced

    def abort(self) -> List[ModelBundle]:
        """Discard the staged bundle (prepare failed fleet-wide, digest
        disagreement, operator abort). No-op when nothing is staged —
        abort must be safe to broadcast. An abort that lands while a
        prepare is still LOADING cancels it: the late stage() is
        refused and the preparer cleans itself up (the claim is never
        force-released here, so a racing second prepare cannot
        interleave with the dying one)."""
        with self._lock:
            staged, self._staged = self._staged, None
            if self._preparing:
                self._cancelled_before = self._next_epoch
            snap = self._snapshot_locked()
        if staged is not None:
            self.metrics.counter("serve_swap_errors").inc()
        self._publish_locked_out(snap)
        return [staged] if staged is not None else []

    def rollback(self, expect_current: Optional[str] = None
                 ) -> List[ModelBundle]:
        """current <-> prev: instant, both bundles warm. Symmetric — a
        second rollback re-instates the rolled-away model (operator
        ping-pong is safe); nothing is displaced. `expect_current`
        guards a CONDITIONAL rollback (the fleet commit-failure
        recovery): it only runs if the serving digest IS the one being
        rolled away — a replica whose commit never landed refuses
        typed instead of blindly re-instating some older model."""
        with self._lock:
            if self._prev is None:
                raise SwapError("nothing to roll back to (no previous "
                                "model bundle is retained)")
            if expect_current is not None \
                    and self._current.digest != expect_current:
                raise ConditionalRollbackRefused(
                    f"conditional rollback refused: serving digest "
                    f"{self._current.digest!r} is not the expected "
                    f"{expect_current!r} (this replica never committed "
                    f"the model being rolled back)")
            self._current, self._prev = self._prev, self._current
            snap = self._snapshot_locked()
        self.metrics.counter("serve_rollbacks").inc()
        self._publish_locked_out(snap)
        return []


class RollbackWatchdog:
    """Post-swap automatic rollback trigger.

    The one health signal a just-committed model cannot fake is its
    typed-error rate against live traffic. The watchdog keeps a short
    sliding window of (time, typed_errors, resolved) counter samples —
    the supervisor feeds it one sample per tick — and on every
    `commit_swap` ARMS a comparison: the typed-error rate over the
    `window_s` BEFORE the commit (the old model's baseline) versus the
    rate over the first `min_requests`-plus resolutions AFTER it. Once
    the post window has both elapsed and seen enough traffic to judge,
    `evaluate` returns a verdict exactly once; a post-minus-pre rate
    jump beyond `threshold` tells the service to call
    `rollback(expect_current=<committed digest>)` — CONDITIONAL, so a
    watchdog racing an operator who already rolled back refuses typed
    instead of double-flipping models.

    Canary watch: `arm` also pins the committed digest for
    the golden canary, and keeps watching it even after a HEALTHY
    error-rate verdict — a numerically degraded model emits wrong
    BYTES, not typed errors, so the rate comparison can come back clean
    while the canary is still probing. `note_canary_failure(digest)`
    against the watched digest makes the next `evaluate` fire
    immediately (reason "canary"); the watch clears on disarm/rollback
    or the next arm.

    Pure bookkeeping: this class never touches the swap coordinator or
    metrics itself — the service samples the counters, and acts on the
    verdict OUTSIDE this object's lock (rollback takes the
    coordinator's lock, which must never nest under this one)."""

    def __init__(self, window_s: float, threshold: float,
                 min_requests: int):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        if min_requests < 1:
            raise ValueError(f"min_requests must be >= 1, "
                             f"got {min_requests}")
        self.window_s = float(window_s)
        self.threshold = float(threshold)
        self.min_requests = int(min_requests)
        self._lock = threading.Lock()
        # (t, typed_errors, resolved) samples, oldest first
        self._samples: deque = deque()   # guarded-by: self._lock
        self._armed: Optional[Dict[str, Any]] = None  # guarded-by: self._lock
        # the canary watch outlives the error-rate verdict:
        # a healthy error rate clears `_armed` within one window, but
        # the first canary probe of a numerically degraded model can
        # take LONGER than that window (the errors it makes are wrong
        # BYTES, not typed failures) — so the committed digest stays
        # watched until disarm/rollback/next arm, and a canary failure
        # against it fires whenever it lands
        self._watch_digest: Optional[str] = None   # guarded-by: self._lock
        self._canary_failed = False                # guarded-by: self._lock

    @staticmethod
    def _rate(errors: int, resolved: int) -> float:
        return (errors / resolved) if resolved > 0 else 0.0

    def sample(self, now: float, typed_errors: int, resolved: int) -> None:
        """One supervisor-tick counter observation; old samples beyond
        2x the window age out (bounded memory at any tick rate)."""
        with self._lock:
            self._samples.append((now, typed_errors, resolved))
            horizon = now - 2.0 * self.window_s
            while len(self._samples) > 1 and self._samples[0][0] < horizon:
                self._samples.popleft()

    def arm(self, now: float, digest: str, typed_errors: int,
            resolved: int) -> None:
        """Called at commit: pin the committed digest, the post-window
        baseline counters, and the PRE-swap error rate computed from
        the sample window ending now."""
        with self._lock:
            base_t, base_e, base_r = now, typed_errors, resolved
            # oldest sample still inside the pre window = the baseline
            pre_e = pre_r = 0
            for t, e, r in self._samples:
                if t >= now - self.window_s:
                    pre_e, pre_r = typed_errors - e, resolved - r
                    break
            self._armed = {
                "digest": digest,
                "t_commit": base_t,
                "base_errors": base_e,
                "base_resolved": base_r,
                "pre_rate": self._rate(pre_e, pre_r),
            }
            self._watch_digest = digest
            self._canary_failed = False

    def disarm(self) -> None:
        """Manual swap/rollback supersedes a pending comparison AND the
        canary watch — never judge a model that already left."""
        with self._lock:
            self._armed = None
            self._watch_digest = None
            self._canary_failed = False

    def note_canary_failure(self, digest: str) -> bool:
        """Second firing signal: the golden canary observed
        a digest mismatch on the WATCHED model (the last committed
        digest — watched until disarm/rollback/next arm, even after the
        error-rate comparison came back healthy). Canary evidence is
        definitive (pinned inputs through deterministic executables),
        so the next `evaluate` fires immediately — no error-rate window
        to wait out. Ignored (False) when nothing is watched or the
        failure names a different digest (a stale probe racing a
        rollback must not condemn the model that replaced it)."""
        with self._lock:
            if self._watch_digest is None or self._watch_digest != digest:
                return False
            self._canary_failed = True
        return True

    @property
    def armed(self) -> bool:
        with self._lock:
            return self._armed is not None

    def evaluate(self, now: float, typed_errors: int,
                 resolved: int) -> Optional[Dict[str, Any]]:
        """The post-window judgement, returned at most once per arm:
        None while the window is still open or the post-commit traffic
        is below `min_requests` (too little evidence to roll back a
        model over); else {"fire", "pre_rate", "post_rate", "digest"}
        and the watchdog disarms."""
        with self._lock:
            if self._canary_failed:
                # canary evidence stands alone: fire now, regardless of
                # traffic volume or whether the error-rate comparison
                # already returned healthy (wrong BYTES are not typed
                # errors — the rate never sees them)
                digest = self._watch_digest
                self._armed = None
                self._watch_digest = None
                self._canary_failed = False
                return {
                    "fire": True,
                    "reason": "canary",
                    "digest": digest,
                    "window_s": self.window_s,
                }
            armed = self._armed
            if armed is None:
                return None
            if now < armed["t_commit"] + self.window_s:
                return None
            post_resolved = resolved - armed["base_resolved"]
            if post_resolved < self.min_requests:
                return None
            post_rate = self._rate(typed_errors - armed["base_errors"],
                                   post_resolved)
            # the error-rate verdict is returned exactly once; the
            # canary watch on this digest persists (see __init__)
            self._armed = None
        return {
            "fire": post_rate - armed["pre_rate"] > self.threshold,
            "reason": "error_rate",
            "pre_rate": round(armed["pre_rate"], 4),
            "post_rate": round(post_rate, 4),
            "post_resolved": post_resolved,
            "digest": armed["digest"],
            "window_s": self.window_s,
        }
