"""Request tracing + crash flight recorder (a copy of the JAX package's
`serve/trace.py`: the process entropy backend's tasks carry the sampled
contexts to the child and back, `sampled_tuple`, and its coding span is
`SPAN_ENTROPY_PROC`; the front door (`serve/router.py`) mints the context
a replica honours, records `SPAN_ROUTER`, and stitches the fleet's rings
with `merge_trace_snapshots`; the federation (`serve/federation.py`) mints
one tier above and records `SPAN_FEDERATION`).

* **Tracer** — span-based request tracing. A `TraceContext` (trace id +
  head sampling decision) is minted at admission (`service._submit`) and
  rides `batcher.Request` through queue wait -> batch formation -> device
  stage -> entropy task -> SI session lookup/search -> frame. Spans land
  in a bounded ring (O(1) append, overwrite-oldest) and export two ways:
  the `/trace` endpoint on the MetricsServer (JSON) and a Chrome/Perfetto
  trace-event file (`dump_chrome`).

  Sampling is HEAD-based and deterministic (a counter rotation at
  `sample_rate`, no RNG — the same stream samples the same requests
  every run), decided once at mint. Requests that end in a TYPED ERROR
  are always visible: `error(ctx, exc)` records the error span with the
  trace id even for head-unsampled contexts. The unsampled fast path
  records nothing and allocates nothing.

  Spans wrap stage boundaries (device dispatch to results on the host,
  entropy task start to frame), never the kernels themselves.

* **FlightRecorder** — a SECOND, always-on bounded ring of recent
  structured events: admission decisions, sheds, batch seals, session
  evictions, worker restarts. Whenever a typed error resolves a future or
  a worker dies, the recorder auto-dumps the ring to a JSONL artifact
  (rate-limited, written by a dedicated daemon thread — never file I/O
  under a lock). With no `dump_dir` the ring still records and is
  queryable via `snapshot()`; only the file dump is off.

A `threading.Lock` guards each ring where the JAX package uses its ranked
locks; ring and meta locks are never nested.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Mapping,
                    NamedTuple, Optional, Sequence, Tuple)


#: span taxonomy: one name per pipeline stage, shared by the serialized
#: and pipelined dataplanes so a timeline reads the same in both modes
SPAN_QUEUE = "queue.wait"           # arrival -> batch formation
SPAN_DEVICE = "batch.device"        # device dispatch -> results on host
SPAN_ENTROPY = "batch.entropy"      # batch rANS work (bridge-side span)
SPAN_ENTROPY_PROC = "batch.entropy.proc"  # child-side coding (process backend)
SPAN_SI_SEARCH = "batch.si_search"  # fused decode->siFinder->siNet executable
SPAN_SESSION = "session.lookup"     # SI session store lookup at batch start
SPAN_ROUTER = "router.dispatch"     # front-door send -> future resolution
SPAN_FEDERATION = "federation.dispatch"  # federation hop -> member resolution
SPAN_ERROR = "error"                # typed-error resolution (always recorded)


class TraceContext(NamedTuple):
    """The unit that rides a request: picklable, immutable, tiny.
    `sampled` is the HEAD decision — every stage records spans for a
    sampled context."""
    trace_id: str
    sampled: bool
    origin: str = "service"


class _Ring:
    """Bounded overwrite-oldest ring under its lock: O(1) append, snapshot returns oldest-first. Items are
    append-only dicts (never mutated after append), so snapshot's
    shallow copy is safe to hand out."""

    __slots__ = ("_lock", "_buf", "_n", "capacity")

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)   # immutable after construction
        self._lock = threading.Lock()
        self._buf: List[Optional[dict]] = [None] * self.capacity  # guarded-by: self._lock
        self._n = 0                                               # guarded-by: self._lock

    def append(self, item: dict) -> None:
        with self._lock:
            self._buf[self._n % len(self._buf)] = item
            self._n += 1

    def snapshot(self) -> Tuple[List[dict], int]:
        """-> (items oldest-first, total ever appended)."""
        with self._lock:
            n = self._n
            cap = len(self._buf)
            if n <= cap:
                return [s for s in self._buf[:n]], n
            i = n % cap
            return self._buf[i:] + self._buf[:i], n


class Tracer:
    """Span recorder with deterministic head sampling.

    The recording surface is shaped for the dataplane's hot path:
    `span_batch(requests, ...)` reads each request's `.trace` attribute
    and records ONE span carrying every sampled trace id in the batch —
    when nothing is sampled it returns without allocating. All spans
    carry wall-clock anchors (`ts`) besides their monotonic-derived
    duration, so they compare with timelines of other processes."""

    def __init__(self, sample_rate: float = 0.0, capacity: int = 4096,
                 enabled: bool = True, metrics=None):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"trace sample_rate must be in [0, 1], "
                             f"got {sample_rate}")
        self._ring = _Ring(capacity)
        # mint state under its own lock (never nested with the ring's:
        # mint never records, record never mints)
        self._mint_lock = threading.Lock()
        self._minted = 0       # guarded-by: self._mint_lock
        self._n_sampled = 0    # guarded-by: self._mint_lock
        self._rate = float(sample_rate)   # guarded-by: self._mint_lock
        self._enabled = bool(enabled)
        # per-process id prefix: ids stay unique across processes
        # without coordination
        self._prefix = f"t{os.getpid():x}-{id(self) & 0xffff:04x}"
        self.metrics = metrics

    # -- knobs ---------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> bool:
        """Flip the whole tracer (mint + record); returns the previous
        value. The bench's overhead comparison toggles this."""
        prev = self._enabled
        self._enabled = bool(on)
        return prev

    @property
    def sample_rate(self) -> float:
        with self._mint_lock:
            return self._rate

    def set_sample_rate(self, rate: float) -> float:
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"trace sample_rate must be in [0, 1], "
                             f"got {rate}")
        with self._mint_lock:
            prev, self._rate = self._rate, float(rate)
        return prev

    # -- minting -------------------------------------------------------------

    def mint(self, origin: str = "service") -> Optional[TraceContext]:
        """One context per admitted request. The sampling decision is a
        deterministic counter rotation at the configured rate (the
        serve_bench `_mixed_class` idiom): the Nth minted request is
        sampled iff floor((N+1)*rate) > floor(N*rate) — no RNG, so a
        replayed stream traces the same requests."""
        if not self._enabled:
            return None
        with self._mint_lock:
            n = self._minted
            self._minted = n + 1
            sampled = int((n + 1) * self._rate) > int(n * self._rate)
            if sampled:
                self._n_sampled += 1
        return TraceContext(f"{self._prefix}-{n:08x}", sampled, origin)

    # -- recording -----------------------------------------------------------

    def record(self, name: str, t0: float, t1: float,
               tids: Sequence[str], **args) -> None:
        """Low-level span append; `t0`/`t1` are time.monotonic() stage
        endpoints measured by the CALLER (the same instants the metric
        accumulators integrate, so the two instrumentation layers can be
        held to each other)."""
        if not self._enabled or not tids:
            return
        now_m = time.monotonic()
        span = {
            "name": name,
            "tid": tids[0],
            "tids": list(tids),
            # wall-clock anchor of the span START: comparable across
            # processes (monotonic bases are not)
            "ts": time.time() - (now_m - t0),
            "dur_ms": round((t1 - t0) * 1e3, 4),
            "pid": os.getpid(),
            "thread": threading.current_thread().name,
        }
        if args:
            span["args"] = args
        self._ring.append(span)
        if self.metrics is not None:
            # span volume on /metrics: ring occupancy vs overwrite rate
            # is how an operator sizes trace_capacity
            self.metrics.counter("serve_trace_spans").inc()

    def span_for(self, ctx: Optional[TraceContext], name: str,
                 t0: float, t1: float, **args) -> None:
        """Single-context convenience (the router's dispatch span)."""
        if ctx is not None and ctx.sampled:
            self.record(name, t0, t1, [ctx.trace_id], **args)

    def span_batch(self, requests: Iterable[Any], name: str,
                   t0: float, t1: float, **args) -> None:
        """Record one span for the SAMPLED subset of a batch's requests
        (each carrying `.trace`). The all-unsampled path allocates
        nothing: the id list is only built once a sampled context is
        seen."""
        if not self._enabled:
            return
        tids = None
        for r in requests:
            ctx = r.trace
            if ctx is not None and ctx.sampled:
                if tids is None:
                    tids = []
                tids.append(ctx.trace_id)
        if tids:
            self.record(name, t0, t1, tids, **args)

    def sampled_tuple(self, requests: Iterable[Any]
                      ) -> Optional[Tuple[TraceContext, ...]]:
        """The sampled contexts of a batch as a picklable tuple (what the
        process entropy backend ships with its task), or None when nothing
        is sampled: the task then carries no trace bytes."""
        if not self._enabled:
            return None
        out = [r.trace for r in requests
               if r.trace is not None and r.trace.sampled]
        return tuple(out) if out else None

    def error(self, ctx: Optional[TraceContext],
              exc: BaseException) -> None:
        """Typed-error visibility: record the error span for ANY
        context, sampled or not — the always-on half of the sampling
        contract (an error trace id must resolve to at least its
        failure, never to nothing)."""
        if not self._enabled or ctx is None:
            return
        t = time.monotonic()
        self.record(SPAN_ERROR, t, t, [ctx.trace_id],
                    error=type(exc).__name__, message=str(exc)[:200])

    # -- export --------------------------------------------------------------

    def snapshot(self, trace_id: Optional[str] = None) -> dict:
        """{"spans": [...], "recorded": total appended, "dropped":
        overwritten count, "minted"/"sampled": mint census}. With
        `trace_id`, spans are filtered to that trace (primary id or
        batch membership)."""
        spans, total = self._ring.snapshot()
        if trace_id is not None:
            spans = [s for s in spans
                     if s["tid"] == trace_id or trace_id in s["tids"]]
        with self._mint_lock:
            minted, sampled, rate = (self._minted, self._n_sampled,
                                     self._rate)
        return {
            "spans": spans,
            "recorded": total,
            "dropped": max(0, total - self._ring.capacity),
            "capacity": self._ring.capacity,
            "enabled": self._enabled,
            "sample_rate": rate,
            "minted": minted,
            "sampled": sampled,
        }

    def stage_totals_ms(self) -> Dict[str, float]:
        """Summed span duration per stage name over the CURRENT ring —
        the tracer-side number the serve_bench cross-check holds
        against the `serve_*_ms` accumulators."""
        totals: Dict[str, float] = {}
        spans, _ = self._ring.snapshot()
        for s in spans:
            totals[s["name"]] = totals.get(s["name"], 0.0) + s["dur_ms"]
        return totals

    def reset(self) -> None:
        """Drop every recorded span (benches isolate passes); mint
        state (ids, sampling rotation) is preserved."""
        with self._ring._lock:
            self._ring._buf = [None] * self._ring.capacity
            self._ring._n = 0

    def http_snapshot(self, params: Mapping[str, str]) -> object:
        """The `/trace` endpoint body for this process (MetricsServer's
        trace provider contract): `?id=` filters one trace,
        `?format=chrome` returns the Chrome/Perfetto trace-event dict."""
        if params.get("format") == "chrome":
            return chrome_trace(self.snapshot()["spans"])
        return self.snapshot(trace_id=params.get("id"))

    def dump_chrome(self, path: str) -> int:
        """Write the ring as a Chrome/Perfetto trace-event file (load
        via chrome://tracing or ui.perfetto.dev); returns the number of
        events written. Temp+rename so a crash cannot truncate it."""
        events = chrome_trace(self.snapshot()["spans"])
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(events, f)
        os.replace(tmp, path)
        return len(events["traceEvents"])


def chrome_trace(spans: Sequence[dict]) -> dict:
    """Spans -> the Chrome trace-event JSON dict (complete 'X' events;
    `ts`/`dur` in microseconds per the format spec)."""
    events = []
    for s in spans:
        events.append({
            "name": s["name"],
            "ph": "X",
            "ts": s["ts"] * 1e6,
            "dur": s["dur_ms"] * 1e3,
            "pid": s["pid"],
            "tid": s["thread"],
            "args": {"trace_ids": s["tids"], **s.get("args", {})},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def merge_trace_snapshots(parts: Sequence[dict]) -> List[dict]:
    """Fleet stitch: concatenate per-process span lists onto one
    timeline, ordered by their wall-clock anchors (the router's
    AggregatedTraces feeds this its own snapshot plus every replica
    scrape)."""
    spans: List[dict] = []
    for part in parts:
        spans.extend(part.get("spans", ()))
    spans.sort(key=lambda s: s["ts"])
    return spans


class FlightRecorder:
    """Always-on ring of recent structured events + typed-error/death
    triggered JSONL dumps.

    `record(kind, **fields)` is the O(1) hot-path surface (legal from
    under any other serve-stack lock). `note_error` /
    `note_death` record AND schedule a dump; the dump itself — a ring
    snapshot written to `dump_dir/flight-<pid>-<seq>.jsonl` via
    temp+rename — runs on a dedicated daemon thread, rate-limited by
    `min_dump_interval_s` (a typed-error storm coalesces into one dump
    per interval, each covering the whole storm so far). `flush()`
    waits for every scheduled dump (tests and bench artifacts)."""

    def __init__(self, capacity: int = 2048,
                 dump_dir: Optional[str] = None,
                 min_dump_interval_s: float = 1.0,
                 metrics=None, enabled: bool = True):
        if min_dump_interval_s < 0:
            raise ValueError(f"min_dump_interval_s must be >= 0, got "
                             f"{min_dump_interval_s}")
        self._ring = _Ring(capacity)
        self._meta_lock = threading.Lock()
        self._want = 0          # dump requests issued      guarded-by: self._meta_lock
        self._done = 0          # dump requests satisfied   guarded-by: self._meta_lock
        self._dumps = 0         # files written             guarded-by: self._meta_lock
        self._last_reason = None          # guarded-by: self._meta_lock
        self._last_dump_path: Optional[str] = None  # guarded-by: self._meta_lock
        self._thread: Optional[threading.Thread] = None  # guarded-by: self._meta_lock
        self._wake = threading.Event()
        self._closed = threading.Event()
        self._min_interval = float(min_dump_interval_s)
        self._dump_dir = dump_dir
        self._enabled = bool(enabled)
        self.metrics = metrics

    # -- knobs ---------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> bool:
        prev = self._enabled
        self._enabled = bool(on)
        return prev

    @property
    def dump_dir(self) -> Optional[str]:
        return self._dump_dir

    # -- recording -----------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        if not self._enabled:
            return
        self._ring.append({"t": time.time(), "kind": kind, **fields})

    def note_error(self, exc: BaseException,
                   trace_id: Optional[str] = None) -> None:
        """A typed error just resolved a future: record it and schedule
        a dump — the '200ms before the error' forensic artifact."""
        if not self._enabled:
            return
        self.record("typed_error", error=type(exc).__name__,
                    message=str(exc)[:200], trace_id=trace_id)
        self.trigger_dump("typed_error")

    def note_death(self, what: str, **fields) -> None:
        """A worker died: record + dump."""
        if not self._enabled:
            return
        self.record(what, **fields)
        self.trigger_dump(what)

    # -- dumping -------------------------------------------------------------

    def trigger_dump(self, reason: str) -> None:
        """Schedule a dump (no-op without a dump_dir). Never performs
        file I/O on the calling thread — callers may hold serve-stack
        locks."""
        if not self._enabled or self._dump_dir is None \
                or self._closed.is_set():
            return
        with self._meta_lock:
            self._want += 1
            self._last_reason = reason
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._dump_loop, name="serve-flight-dump",
                    daemon=True)
                self._thread.start()
        self._wake.set()

    def _dump_loop(self) -> None:
        last_dump_t = 0.0
        while True:
            self._wake.wait()
            if self._closed.is_set():
                return
            self._wake.clear()
            # rate limit OUTSIDE any lock; triggers landing during the
            # sleep coalesce into this dump (their events are already
            # in the ring when we snapshot)
            delay = self._min_interval - (time.monotonic() - last_dump_t)
            if delay > 0:
                time.sleep(delay)
            with self._meta_lock:
                want = self._want
                reason = self._last_reason
            events, _total = self._ring.snapshot()
            path = None
            try:
                os.makedirs(self._dump_dir, exist_ok=True)
                with self._meta_lock:
                    seq = self._dumps
                path = os.path.join(
                    self._dump_dir,
                    f"flight-{os.getpid()}-{seq:04d}.jsonl")
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(json.dumps({"kind": "_dump", "t": time.time(),
                                        "reason": reason,
                                        "events": len(events)},
                                       default=str) + "\n")
                    for ev in events:
                        f.write(json.dumps(ev, default=str) + "\n")
                os.replace(tmp, path)
            except OSError:
                path = None   # an unwritable dir must not kill the loop
            last_dump_t = time.monotonic()
            with self._meta_lock:
                self._done = want
                if path is not None:
                    self._dumps += 1
                    self._last_dump_path = path
            if path is not None and self.metrics is not None:
                self.metrics.counter("serve_flight_dumps").inc()

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every dump scheduled so far has been written
        (True) or the timeout passes (False)."""
        with self._meta_lock:
            target = self._want
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._meta_lock:
                if self._done >= target:
                    return True
            time.sleep(0.005)
        with self._meta_lock:
            return self._done >= target

    def close(self) -> None:
        """Stop the dump thread (drain path). Idempotent; events
        already recorded stay queryable."""
        self._closed.set()
        self._wake.set()
        with self._meta_lock:
            t = self._thread
        if t is not None:
            t.join(timeout=5)

    # -- export --------------------------------------------------------------

    def snapshot(self) -> List[dict]:
        events, _ = self._ring.snapshot()
        return events

    def meta(self) -> dict:
        """Dump bookkeeping for /trace, bench artifacts, and chaos
        violation reports."""
        events, total = self._ring.snapshot()
        with self._meta_lock:
            return {"events": len(events), "recorded": total,
                    "dumps": self._dumps,
                    "last_dump_path": self._last_dump_path,
                    "dump_dir": self._dump_dir,
                    "pending": max(0, self._want - self._done)}


def echo_context(ctx: TraceContext) -> TraceContext:
    """Process-pool propagation probe: returns the context exactly as
    received. Submitted to a real spawn executor, equality after the
    round trip is the serialization contract the entropy backend and the
    replica pipe rely on."""
    return ctx
