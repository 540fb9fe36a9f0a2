"""Device-resident side-information session cache (a copy of the JAX
package's `serve/session.py`).

The siFinder search has a large request-INVARIANT half: everything
derived from the side image y alone — the AE reconstruction y-hat, its
color transform, the window statistics behind the Pearson denominator,
the Gaussian prior factors, and on the card the kernel's operands. A
session registers y ONCE; the service computes the whole y-half into an
immutable `ops.sifinder.SidePrep` (`serve/device.py` builds it) and this
store keeps it on the device across requests.

The store is a bounded LRU with byte accounting and an optional idle
TTL:

* **LRU + capacity**: at most `max_sessions` entries and `max_bytes` of
  per-session device tensors; inserting past either bound evicts the
  least-recently-USED session (a `get` refreshes recency). A single
  prep larger than `max_bytes` is refused typed (`SessionOverCapacity`)
  — it could only ever be cached by evicting everyone else.
* **TTL**: with `ttl_s`, a session idle longer than that is expired —
  lazily at access and swept at every insert, so an abandoned session
  cannot pin device memory forever.
* **Typed misses**: every way a session can be gone — never opened,
  LRU-evicted, TTL-expired, built against another model — answers
  `SessionExpired`; the client's recovery is always the same: re-open
  the session.

Sessions are MODEL-VERSIONED: a SidePrep embeds y-hat, which depends on
the serving weights, so `SessionEntry.digest` records the model digest
the prep was built against.

All store state lives under one `threading.Lock` (the JAX package's
ranked `serve.session` lock). The `serve.session` fault site fires on
every lookup, so a seeded fault plan can inject typed faults exactly
where a corrupted or raced session slot would surface.
"""

from __future__ import annotations

import secrets
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from dsin_tpu_torch.serve.batcher import ServeError
from dsin_tpu_torch.utils import faults


class SessionError(ServeError):
    """Base for the session-cache failure modes."""


class SessionExpired(SessionError):
    """The session is gone — never opened, LRU/TTL-evicted, or built
    against another model. Re-open it (register the side image again);
    nothing else recovers a lost prep."""


class SessionOverCapacity(SessionError):
    """One side image's prep alone exceeds the store's byte budget —
    caching it would require evicting every other session. Raise the
    budget or serve that geometry per-request."""


@dataclass(frozen=True)
class SessionEntry:
    """One registered side image: the immutable prep plus the facts the
    dataplane checks before using it."""
    sid: str
    prep: Any                 # ops.sifinder.SidePrep (device tensors)
    bucket: Tuple[int, int]   # geometry the prep was built at — requests
    #                           must route to the SAME bucket
    nbytes: int               # per-session device bytes (byte accounting)
    digest: Optional[str]     # model digest the prep was built against


class _Slot:
    """Mutable store-side wrapper: entry + recency stamp."""

    __slots__ = ("entry", "last_used")

    def __init__(self, entry: SessionEntry, now: float):
        self.entry = entry
        self.last_used = now


class SessionStore:
    """Bounded LRU + TTL + byte-accounted session cache (thread-safe)."""

    def __init__(self, max_sessions: int, max_bytes: int,
                 ttl_s: Optional[float] = None, metrics=None,
                 clock=time.monotonic, flight=None, on_evict=None):
        if max_sessions < 1:
            raise ValueError(f"max_sessions must be >= 1, "
                             f"got {max_sessions}")
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0 (or None), got {ttl_s}")
        self.max_sessions = int(max_sessions)
        self.max_bytes = int(max_bytes)
        self.ttl_s = ttl_s
        self.metrics = metrics
        #: optional serve/trace.py FlightRecorder: evictions are exactly
        #: the "why did my session vanish" events an incident timeline
        #: needs (its ring lock is never held while this store's is
        #: taken, so recording from under this lock is safe)
        self.flight = flight
        #: optional `fn(sid, reason)` fired on EVERY way a session
        #: leaves the store (evict/TTL/swap/clear). Runs under this
        #: store's lock: the hook must not call back into the store.
        self.on_evict = on_evict
        self._clock = clock
        self._lock = threading.Lock()
        # insertion/recency order: first = least recently used
        self._slots: "OrderedDict[str, _Slot]" = OrderedDict()  # guarded-by: self._lock
        self._bytes = 0            # guarded-by: self._lock
        self._counter = 0          # guarded-by: self._lock

    # -- metrics (their locks are leaves; legal from under the store's) -----

    def _publish_locked(self) -> None:
        if self.metrics is None:
            return
        self.metrics.gauge("serve_sessions_live").set(len(self._slots))
        self.metrics.gauge("serve_session_bytes").set(self._bytes)

    def _note_eviction(self, reason: str, n: int = 1) -> None:
        if self.metrics is None or n == 0:
            return
        self.metrics.counter("serve_session_evictions").inc(n)
        self.metrics.counter(f"serve_session_evictions_{reason}").inc(n)

    # -- API ----------------------------------------------------------------

    def next_sid(self) -> str:
        """Generated ids carry a random suffix so they are unique ACROSS
        stores (a front door keying a pin table by sid must never see two
        replicas mint the same id)."""
        with self._lock:
            self._counter += 1
            return f"sess-{self._counter:06d}-{secrets.token_hex(4)}"

    def _evict_locked(self, sid: str, reason: str) -> bool:
        slot = self._slots.pop(sid, None)
        if slot is None:
            return False
        self._bytes -= slot.entry.nbytes
        self._note_eviction(reason)
        if self.flight is not None:
            self.flight.record("session_evict", sid=sid, reason=reason,
                               bucket=list(slot.entry.bucket))
        if self.on_evict is not None:
            self.on_evict(sid, reason)
        return True

    def _sweep_ttl_locked(self, now: float) -> None:
        if self.ttl_s is None:
            return
        dead = [sid for sid, slot in self._slots.items()
                if now - slot.last_used > self.ttl_s]
        for sid in dead:
            self._evict_locked(sid, "ttl")

    def put(self, entry: SessionEntry) -> List[str]:
        """Insert (or replace) a session; returns the sids evicted to
        make room. Eviction order: TTL-dead first, then LRU until both
        the session-count and byte bounds hold."""
        if entry.nbytes > self.max_bytes:
            raise SessionOverCapacity(
                f"session {entry.sid!r} prep is {entry.nbytes} bytes — "
                f"larger than the whole store budget ({self.max_bytes}); "
                f"raise session_max_bytes or serve this geometry "
                f"per-request")
        now = self._clock()
        with self._lock:
            before = set(self._slots)
            self._sweep_ttl_locked(now)
            # replacing an existing sid is not an "eviction" — the caller
            # re-registered the same session
            if entry.sid in self._slots:
                old = self._slots.pop(entry.sid)
                self._bytes -= old.entry.nbytes
            self._slots[entry.sid] = _Slot(entry, now)
            self._bytes += entry.nbytes
            while len(self._slots) > self.max_sessions:
                lru = next(iter(self._slots))
                self._evict_locked(lru, "lru")
            while self._bytes > self.max_bytes:
                lru = next(iter(self._slots))
                self._evict_locked(lru, "bytes")
            self._publish_locked()
            return sorted((before - set(self._slots)) - {entry.sid})

    def get(self, sid: str) -> SessionEntry:
        """Look a session up (refreshing its recency) or raise typed
        `SessionExpired`. The `serve.session` fault site fires here —
        outside the lock, so an injected delay cannot serialize the
        store."""
        faults.inject("serve.session")
        now = self._clock()
        with self._lock:
            slot = self._slots.get(sid)
            if slot is None:
                self._publish_locked()
                raise SessionExpired(
                    f"session {sid!r} is not registered (never opened, "
                    f"evicted, or invalidated) — re-open it")
            if self.ttl_s is not None and now - slot.last_used > self.ttl_s:
                self._evict_locked(sid, "ttl")
                self._publish_locked()
                raise SessionExpired(
                    f"session {sid!r} idle past its {self.ttl_s}s TTL — "
                    f"re-open it")
            slot.last_used = now
            self._slots.move_to_end(sid)
            return slot.entry

    def evict(self, sid: str, reason: str = "closed") -> bool:
        with self._lock:
            out = self._evict_locked(sid, reason)
            self._publish_locked()
            return out

    def clear(self, reason: str) -> int:
        """Evict everything (drain; later, a model hot swap). Returns the
        number of sessions dropped."""
        with self._lock:
            dropped = list(self._slots)
            n = len(dropped)
            self._slots.clear()
            self._bytes = 0
            self._note_eviction(reason, n)
            if self.flight is not None and n:
                self.flight.record("sessions_cleared", reason=reason,
                                   count=n)
            if self.on_evict is not None:
                for sid in dropped:
                    self.on_evict(sid, reason)
            self._publish_locked()
            return n

    @property
    def live(self) -> int:
        with self._lock:
            return len(self._slots)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def snapshot(self) -> Dict[str, dict]:
        """{sid: {bucket, nbytes, idle_s}} for /healthz and tests."""
        now = self._clock()
        with self._lock:
            return {sid: {"bucket": list(slot.entry.bucket),
                          "nbytes": slot.entry.nbytes,
                          "idle_s": round(now - slot.last_used, 3)}
                    for sid, slot in self._slots.items()}
