"""Deterministic fault injection: seeded plans over named sites (a copy of
the JAX package's `utils/faults.py`; a `threading.Lock` guards the plan
where the JAX package uses its ranked lock).

The failure modes that kill learned-codec deployments — a worker thread
dying mid-batch, a flipped bit in an rANS payload, a kill landing in the
middle of a checkpoint save — are exactly the ones ordinary tests never
exercise, because they cannot be provoked from the public API. This
module plants named *injection sites* at those spots; a seeded
`FaultPlan` decides, deterministically per visit, whether a site raises,
delays, or corrupts bytes. tools/chaos_bench.py and the chaos-marked
tests drive the recovery paths through real failures instead of mocks.

Canonical sites (free-form strings; these are the ones wired in):

    serve.worker.batch   top of a serve worker's batch processing
    serve.rans           decode-side entropy payload bytes (worker-side)
    serve.swap           the model hot-swap windows (after the incoming
                         params load in prepare, and the commit window
                         right before the atomic bundle swap)
    ckpt.write           each durable checkpoint file write
    ckpt.swap            the window between the checkpoint swap renames
    ckpt.manifest        manifest.json bytes as a loader reads them
                         (corrupt = the torn/rotted-manifest scenario)
    io.read              CLI stream-file reads

Hot-path cost: `inject(site)` / `corrupt(site, data)` are a single
module-global read when no plan is installed — production pays one
`is None` check per site visit, nothing else. Plans are process-global
and thread-safe (serve workers visit sites concurrently); decisions come
from one seeded `random.Random`, so a (seed, visit-sequence) pair always
produces the same faults.
"""

from __future__ import annotations

import random
import threading
import time
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple


SITES = ("serve.worker.batch", "serve.rans", "serve.swap", "serve.session",
         "serve.shm.lane", "ckpt.write", "ckpt.swap", "ckpt.manifest",
         "io.read")

ACTIONS = ("raise", "crash", "delay", "corrupt")


class InjectedFault(RuntimeError):
    """The ordinary injected failure: an `Exception`, so per-request
    isolation (`except Exception`) may answer it like any other error."""


class InjectedCrash(BaseException):
    """Deliberately NOT an `Exception`: models the conditions that must
    kill a worker thread outright (the class of errors `except
    Exception:` recovery code is required to let through — the
    supervisor, not the batch loop, owns this failure)."""


@dataclass
class FaultSpec:
    """One rule: at `site`, from visit `after + 1` on, fire `action` with
    `probability` per visit, at most `times` activations total.

    Actions: ``raise`` raises `exc()` (default InjectedFault);
    ``crash`` raises InjectedCrash; ``delay`` sleeps `delay_s`;
    ``corrupt`` flips `flips` bits of the bytes passed to `corrupt()`
    (a no-op at sites visited through bare `inject()`).
    """

    site: str
    action: str = "raise"
    probability: float = 1.0
    after: int = 0
    times: Optional[int] = None
    delay_s: float = 0.01
    flips: int = 1
    exc: Optional[Callable[[], BaseException]] = None

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown action {self.action!r}; "
                             f"expected one of {ACTIONS}")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(f"probability must be in [0, 1], "
                             f"got {self.probability}")


@dataclass
class Activation:
    """One fired fault, for post-run assertions (chaos_bench's ledger)."""

    site: str
    action: str
    visit: int          # 1-based visit index at the site when it fired


class FaultPlan:
    """A seeded set of FaultSpecs plus the bookkeeping to replay it.

    `visits` counts every site visit (fired or not); `activations`
    counts fired faults per site; `log` records each firing in order.
    All three are safe to read after the run for assertions.
    """

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed
        self.visits: Counter = Counter()
        self.activations: Counter = Counter()
        self.log: List[Activation] = []
        self._rng = random.Random(seed)     # guarded-by: self._lock
        self._fired = [0] * len(self.specs)  # guarded-by: self._lock
        self._lock = threading.Lock()

    def _select(self, site: str) -> Optional[Tuple[FaultSpec, int]]:
        """Count one visit at `site`; return the first spec that fires
        (and the visit index), consuming one of its activations."""
        with self._lock:
            self.visits[site] += 1
            visit = self.visits[site]
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if visit <= spec.after:
                    continue
                if spec.times is not None and self._fired[i] >= spec.times:
                    continue
                if (spec.probability < 1.0
                        and self._rng.random() >= spec.probability):
                    continue
                self._fired[i] += 1
                self.activations[site] += 1
                self.log.append(Activation(site, spec.action, visit))
                return spec, visit
        return None

    def _corrupt_bytes(self, spec: FaultSpec, data: bytes) -> bytes:
        if not data:
            return data
        out = bytearray(data)
        with self._lock:
            for _ in range(spec.flips):
                bit = self._rng.randrange(len(out) * 8)
                out[bit // 8] ^= 1 << (bit % 8)
        return bytes(out)


_ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make `plan` the process-global active plan (replacing any)."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def uninstall() -> None:
    """Remove the active plan; every site becomes a no-op again."""
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultPlan]:
    return _ACTIVE


@contextmanager
def installed(plan: FaultPlan):
    """Scoped install: restores whatever plan (or None) was active."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def _fire(spec: FaultSpec, site: str,
          data: Optional[bytes]) -> Optional[bytes]:
    if spec.action == "delay":
        # sleep OUTSIDE the plan lock: a delayed site must not serialize
        # the other workers' visits behind it
        time.sleep(spec.delay_s)
        return data
    if spec.action == "corrupt":
        if data is None:
            return None
        return _ACTIVE._corrupt_bytes(spec, data) if _ACTIVE else data
    if spec.action == "crash":
        raise InjectedCrash(f"injected crash at {site}")
    exc = spec.exc() if spec.exc is not None else InjectedFault(
        f"injected fault at {site}")
    raise exc


def inject(site: str) -> None:
    """Visit `site`: no-op without a plan; otherwise the plan may raise
    or delay here. `corrupt` specs never act through this entry."""
    plan = _ACTIVE
    if plan is None:
        return
    hit = plan._select(site)
    if hit is not None:
        _fire(hit[0], site, None)


def corrupt(site: str, data: bytes) -> bytes:
    """Pass `data` through `site`: returned unchanged without a plan;
    a firing spec may corrupt it, delay, or raise."""
    plan = _ACTIVE
    if plan is None:
        return data
    hit = plan._select(site)
    if hit is None:
        return data
    out = _fire(hit[0], site, data)
    return data if out is None else out
