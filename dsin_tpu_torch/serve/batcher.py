"""Dynamic micro-batcher: bounded queues + same-bucket coalescing,
priority-class aware.

The throughput/latency trade every batched service makes, with explicit
failure semantics instead of the two silent ones:

* **Backpressure, not buffering**: `submit` on a full queue raises
  `ServiceOverloaded` IMMEDIATELY. An unbounded queue converts overload
  into unbounded memory growth plus latencies every client has already
  given up on — rejecting at the door is the only behavior a load
  balancer upstream can act on.
* **Deadlines, not zombie work**: a request whose deadline passes while
  queued is completed with `DeadlineExceeded` and never batched —
  serving an answer nobody is waiting for still costs a batch slot.

Priority classes: millions of users means tiered traffic, not
one FIFO — a bulk encode burst must not blow the p99 of a
latency-sensitive decode. The batcher therefore takes an ordered tuple
of `PriorityClass`es (first = most latency-sensitive; default: one
"default" class, the pre-priority behavior). Each class carries

* its own BOUNDED queue (`max_queue` per class, on top of the shared
  total bound) — a bulk flood can only ever occupy bulk's slots;
* a per-class DEFAULT DEADLINE (`default_deadline_ms`, applied at
  submit when the request carries none) — bulk work queued past its
  usefulness expires typed instead of rotting;
* a defined SHED ORDER under overload: when the shared total bound is
  hit, a higher-class submit evicts the NEWEST queued request of the
  lowest non-empty class below it (`interactive` admits while `bulk`
  sheds; the victim's future resolves with a typed per-class
  `ServiceOverloaded`). A submit with no lower-class victim sheds
  itself. Every shed/expiry error names its class and the depth at the
  moment of the decision, so shed decisions are debuggable from logs
  alone.

Coalescing: requests carry an opaque hashable `key` ((kind, bucket) in
the service); a batch only ever contains one (class, key), because one
key maps to one XLA executable. Popping is CLASS-THEN-BUCKET aware: a
worker serves the highest-priority class with work first, and within a
class picks keys ROUND-ROBIN across the live (non-empty) key queues —
the probe resumes after the last key served, so a hot small bucket
whose queue never drains cannot monopolize the workers: every live key
is at most #live-keys pops from service within its class
(weighted-fair across buckets; FIFO within a (class, key)). Strict
priority across classes is deliberate: bulk's starvation mode under
sustained interactive load is bounded by its own deadline/shed
contract, not by stealing interactive's latency budget. The worker
then waits up to `max_wait_ms` for the chosen queue to fill to
`max_batch` — the head request's age bounds added latency, late
same-bucket arrivals ride along free.

All batcher state lives under ONE condition (the `on_expired`/`on_shed`
callbacks run under it and report into the metrics' own locks).

This is a copy of the JAX package's `serve/batcher.py`: a
`threading.Condition` over a `threading.Lock` stands where the JAX package
uses its ranked condition.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (AbstractSet, Any, Callable, Dict, Hashable, List,
                    NamedTuple, Optional, Sequence, Tuple)


#: the two traffic classes the serve stack ships with (serve/router.py
#: routes by them; ServiceConfig.priority_classes enables them)
INTERACTIVE = "interactive"
BULK = "bulk"


class ServeError(RuntimeError):
    """Base for every request-rejection mode the service can answer with."""


class ServiceOverloaded(ServeError):
    """Queue full — shed load now; retry against another replica/later.

    Typed per class: `priority` names the class whose bound (or shed
    decision) produced this, `depth` the class/queue depth at that
    moment — both also spelled out in the message so a log line alone
    identifies the guilty queue."""

    def __init__(self, msg: str, priority: Optional[str] = None,
                 depth: Optional[int] = None):
        super().__init__(msg)
        self.priority = priority
        self.depth = depth


class ServiceDraining(ServeError):
    """Service is shutting down — it finishes in-flight work only."""


class ServiceUnavailable(ServeError):
    """No live workers — nothing would drain the queue, so accepting the
    request could only park it until its deadline. Fail fast instead;
    the supervisor is restarting the pool (serve/service.py)."""


class DeadlineExceeded(ServeError):
    """Deadline passed while the request was still queued. `priority`
    names the request's class (per-class deadline accounting)."""

    def __init__(self, msg: str, priority: Optional[str] = None):
        super().__init__(msg)
        self.priority = priority


class UnknownPriorityClass(ServeError, ValueError):
    """The request names a traffic class this service was not
    configured with — client misuse, typed (contract-typed-raise) so
    the front door can reject it as a 4xx instead of a crash. Also a
    ValueError: callers that treated the old bare raise as argument
    validation keep working."""


@dataclass(frozen=True)
class PriorityClass:
    """One traffic class: its queue bound and its default deadline.
    Order in the `MicroBatcher(classes=...)` tuple IS the policy —
    earlier classes pop first and shed last."""
    name: str
    max_queue: int
    default_deadline_ms: Optional[float] = None

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError(f"class {self.name!r}: max_queue must be "
                             f">= 1, got {self.max_queue}")
        if (self.default_deadline_ms is not None
                and self.default_deadline_ms <= 0):
            raise ValueError(f"class {self.name!r}: default_deadline_ms "
                             f"must be > 0, got {self.default_deadline_ms}")


def default_priority_classes(
        max_queue: int,
        interactive_deadline_ms: Optional[float] = None,
        bulk_deadline_ms: Optional[float] = None,
        bulk_max_queue: Optional[int] = None,
) -> Tuple[PriorityClass, PriorityClass]:
    """The shipped two-class policy: `interactive` pops first and sheds
    last; `bulk` takes the overload. Each class is bounded at
    `max_queue` by default (the shared total bound is what forces the
    shed interplay); cap bulk tighter with `bulk_max_queue`."""
    return (PriorityClass(INTERACTIVE, max_queue=max_queue,
                          default_deadline_ms=interactive_deadline_ms),
            PriorityClass(BULK,
                          max_queue=(max_queue if bulk_max_queue is None
                                     else bulk_max_queue),
                          default_deadline_ms=bulk_deadline_ms))


class Future:
    """Minimal one-shot result slot (stdlib Event; no asyncio loop to
    own). `add_done_callback` exists for the front door: the admission
    gate (serve/router.py) releases its per-class slot the moment the
    future resolves, on the resolving thread — callbacks must stay
    cheap and leaf-locked (they may run under the batcher condition,
    e.g. when a shed or drain resolves the future)."""

    def __init__(self):
        self._done = threading.Event()
        self._result: Any = None
        self._exc: Optional[BaseException] = None
        self._cb_lock = threading.Lock()
        # None once fired: late add_done_callback runs immediately
        self._callbacks: Optional[List[Callable]] = []  # guarded-by: self._cb_lock

    def _fire_callbacks(self) -> None:
        with self._cb_lock:
            cbs = self._callbacks or []
            self._callbacks = None
        for cb in cbs:
            cb(self)

    def set_result(self, value: Any) -> None:
        self._result = value
        self._done.set()
        self._fire_callbacks()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()
        self._fire_callbacks()

    def add_done_callback(self, fn: Callable[["Future"], None]) -> None:
        """Run `fn(self)` once the future resolves — immediately (on the
        calling thread) if it already has, else exactly once on the
        resolving thread. Callbacks fire at most once per future even
        if a buggy caller double-resolves."""
        with self._cb_lock:
            if self._callbacks is not None:
                self._callbacks.append(fn)
                return
        fn(self)

    def done(self) -> bool:
        return self._done.is_set()

    def exception(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("request still pending")
        return self._exc

    def result(self, timeout: Optional[float] = None) -> Any:
        exc = self.exception(timeout)
        if exc is not None:
            raise exc
        return self._result


class SessionKey(NamedTuple):
    """Internal queue key for session-affine requests: the
    routing half (`route` — the caller's `Request.key`, what `accept`
    filters and executables are keyed by) plus the session id. Two
    requests coalesce only when BOTH halves match, so a batch never
    mixes side images — one session, one device-resident SidePrep, one
    executable call."""
    route: Hashable
    session: str


@dataclass
class Request:
    """One unit of work. `payload` is opaque to the batcher; `key`
    decides what it may be batched with; `deadline` is absolute
    time.monotonic(); `priority` names a configured class (None = the
    batcher's first/most-latency-sensitive class, filled in at
    submit). `session` narrows coalescing: requests sharing
    a key still only batch together when they also share the session —
    consumers' `accept` sets keep filtering on the key alone. `trace`
    is the request's TraceContext (serve/trace.py), minted
    at admission and read by every pipeline stage that records a span —
    opaque to the batcher itself."""
    key: Hashable
    payload: Any
    deadline: Optional[float] = None
    future: Future = field(default_factory=Future)
    arrival: float = field(default_factory=time.monotonic)
    priority: Optional[str] = None
    session: Optional[str] = None
    trace: Optional[Any] = None


class MicroBatcher:
    """Bounded multi-queue with same-key coalescing, priority classes,
    deadlines, and drain.

    Contract:
      submit(req)        -> enqueue | raise ServiceOverloaded (typed:
                            class + depth in the message and on the
                            exception) / ServiceDraining; may SHED the
                            newest lower-class request to admit a
                            higher-class one when the total bound is hit
      next_batch(t)      -> [Request, ...] (one (class, key), 1..max_batch)
                            | [] on timeout | None once closed AND empty
      close()            -> reject everything queued with ServiceDraining;
                            workers mid-batch are unaffected (in-flight
                            work completes — that is the drain guarantee)

    Device-affine consumers (serve/placement.py): `next_batch(accept=…)`
    takes an optional key SET — keys outside it are invisible to THIS
    call (across every class), so a per-device executor only ever pops
    batches for buckets placed on its device while other executors
    drain the rest. The round-robin ring is shared across consumers
    (fairness is per-bucket, not per-consumer); a consumer whose
    accepted keys are all empty waits exactly like one facing an empty
    batcher.
    """

    def __init__(self, max_batch: int, max_wait_ms: float, max_queue: int,
                 on_expired=None, classes: Optional[Sequence[PriorityClass]]
                 = None, on_shed=None):
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1000.0
        self.max_queue = int(max_queue)
        if classes is None:
            classes = (PriorityClass("default", max_queue=self.max_queue),)
        if not classes:
            raise ValueError("need at least one priority class")
        names = [pc.name for pc in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate priority class names: {names}")
        #: pop-priority order: classes[0] pops first, sheds last
        self.classes: Tuple[PriorityClass, ...] = tuple(classes)
        self._by_name: Dict[str, PriorityClass] = {pc.name: pc
                                                   for pc in self.classes}
        self.default_class = self.classes[0].name
        #: called with (total expired, {class: count}) — deadline-expired
        #: requests (under the batcher lock — keep it leaf-locked and
        #: cheap, e.g. metric counters)
        self.on_expired = on_expired
        #: called with (class name, count) per overload shed — same
        #: under-the-lock contract as on_expired
        self.on_shed = on_shed
        self._cond = threading.Condition(threading.Lock())
        # per-class: key -> deque of requests
        self._queues: Dict[str, Dict[Hashable, deque]] = {
            pc.name: {} for pc in self.classes}  # guarded-by: self._cond
        # per-class: live keys in first-seen order / next-probe ring idx
        self._order: Dict[str, List[Hashable]] = {
            pc.name: [] for pc in self.classes}  # guarded-by: self._cond
        self._rr: Dict[str, int] = {pc.name: 0
                                    for pc in self.classes}  # guarded-by: self._cond
        self._class_depth: Dict[str, int] = {
            pc.name: 0 for pc in self.classes}   # guarded-by: self._cond
        self._depth = 0                    # guarded-by: self._cond
        self._closed = False               # guarded-by: self._cond

    # -- producer side ------------------------------------------------------

    def _shed_lower_locked(self, cls: str) -> bool:
        """The overload shed order: evict the NEWEST queued request of
        the lowest-priority non-empty class strictly below `cls`, so
        the incoming higher-class request can take its slot
        ("interactive admits while bulk sheds"). Newest-loses within
        the victim class: it has waited least, so shedding it wastes
        the least queue time. Returns False when no lower-class work is
        queued (the caller then sheds itself)."""
        idx = next(i for i, pc in enumerate(self.classes)
                   if pc.name == cls)
        for pc in reversed(self.classes[idx + 1:]):
            queues = self._queues[pc.name]
            if self._class_depth[pc.name] <= 0 or not queues:
                continue
            # newest request = the latest tail across the class's keys
            # (FIFO append keeps each deque's tail its newest)
            key = max(queues, key=lambda k: queues[k][-1].arrival)
            victim = queues[key].pop()
            if not queues[key]:
                self._drop_key_locked(pc.name, key)
            self._class_depth[pc.name] -= 1
            self._depth -= 1
            depth_now = self._class_depth[pc.name]
            victim.future.set_exception(ServiceOverloaded(
                f"shed under overload: class {pc.name!r} request at key "
                f"{key!r} (class depth now {depth_now}, total "
                f"{self._depth}/{self.max_queue}) gave its slot to an "
                f"incoming {cls!r} request",
                priority=pc.name, depth=depth_now))
            if self.on_shed is not None:
                self.on_shed(pc.name, 1)
            return True
        return False

    # contract: request-path — every reachable raise must be a typed error
    def submit(self, request: Request) -> None:
        with self._cond:
            if self._closed:
                raise ServiceDraining("service is draining; not accepting "
                                      "new requests")
            cls = request.priority
            if cls is None:
                cls = request.priority = self.default_class
            pc = self._by_name.get(cls)
            if pc is None:
                raise UnknownPriorityClass(
                    f"unknown priority class {cls!r} (configured: "
                    f"{[c.name for c in self.classes]})")
            if request.deadline is None and pc.default_deadline_ms is not None:
                request.deadline = (time.monotonic()
                                    + pc.default_deadline_ms / 1000.0)
            cd = self._class_depth[cls]
            if cd >= pc.max_queue:
                raise ServiceOverloaded(
                    f"class {cls!r} queue full ({cd}/{pc.max_queue}) at "
                    f"key {request.key!r} (total {self._depth}/"
                    f"{self.max_queue}) — shed at the door",
                    priority=cls, depth=cd)
            if self._depth >= self.max_queue and \
                    not self._shed_lower_locked(cls):
                raise ServiceOverloaded(
                    f"queue full (total {self._depth}/{self.max_queue}; "
                    f"class {cls!r} at {cd}/{pc.max_queue}) with no "
                    f"lower-priority victim to shed — {cls!r} request at "
                    f"key {request.key!r} shed at the door",
                    priority=cls, depth=self._depth)
            qkey = (request.key if request.session is None
                    else SessionKey(request.key, request.session))
            q = self._queues[cls].get(qkey)
            if q is None:
                q = self._queues[cls][qkey] = deque()
                self._order[cls].append(qkey)
            q.append(request)
            self._class_depth[cls] += 1
            self._depth += 1
            self._cond.notify_all()

    @property
    def depth(self) -> int:
        with self._cond:
            return self._depth

    def class_depths(self) -> Dict[str, int]:
        """{class: queued count} snapshot (front-door observability)."""
        with self._cond:
            return dict(self._class_depth)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    # -- consumer side ------------------------------------------------------

    def _drop_key_locked(self, cls: str, key: Hashable) -> None:
        """Remove an emptied key's queue AND its ring slot, keeping the
        class's round-robin probe pointed at the same successor key."""
        del self._queues[cls][key]
        order = self._order[cls]
        idx = order.index(key)
        del order[idx]
        if idx < self._rr[cls]:
            self._rr[cls] -= 1

    def _expire_locked(self) -> None:
        """Complete every already-dead queued request with
        DeadlineExceeded (holding the lock; O(depth), fine at service
        queue scales)."""
        now = time.monotonic()
        expired: Dict[str, int] = {}
        for cls, queues in self._queues.items():
            for key in list(queues):
                q = queues[key]
                if not any(r.deadline is not None and r.deadline <= now
                           for r in q):
                    continue
                alive = deque(r for r in q
                              if r.deadline is None or r.deadline > now)
                for r in q:
                    if r.deadline is not None and r.deadline <= now:
                        self._depth -= 1
                        self._class_depth[cls] -= 1
                        expired[cls] = expired.get(cls, 0) + 1
                        r.future.set_exception(DeadlineExceeded(
                            f"class {cls!r} deadline passed after "
                            f"{(now - r.arrival) * 1e3:.1f}ms in queue at "
                            f"key {key!r}", priority=cls))
                if alive:
                    queues[key] = alive
                else:
                    self._drop_key_locked(cls, key)
        if expired and self.on_expired is not None:
            self.on_expired(sum(expired.values()), expired)

    def _next_key_locked(self, accept: Optional[AbstractSet[Hashable]] = None
                         ) -> Optional[Tuple[str, Hashable]]:
        """Class-then-bucket pop order: serve the highest-priority class
        with eligible work, round-robin over ITS live keys in
        first-seen ring order, resuming after the last key served.
        Within a class every live key is at most len(ring) pops from
        service, so a hot bucket with a continuously-refilling queue
        cannot starve the others (oldest-head selection could: its head
        is always the oldest while a backlog of its own requests keeps
        arriving behind it). With `accept`, keys outside the set are
        skipped — they stay queued for a consumer that does accept
        them."""
        for pc in self.classes:
            cls = pc.name
            order = self._order[cls]
            n = len(order)
            if n == 0:
                continue
            start = self._rr[cls] % n
            for i in range(n):
                idx = (start + i) % n
                key = order[idx]
                # accept filters on the ROUTE half only: a device-affine
                # executor accepts (kind, bucket); which session rides
                # that bucket is batching policy, not placement
                route = key.route if isinstance(key, SessionKey) else key
                if accept is not None and route not in accept:
                    continue
                if self._queues[cls].get(key):
                    self._rr[cls] = idx + 1
                    return cls, key
        return None

    def next_batch(self, timeout: Optional[float] = None,
                   accept: Optional[AbstractSet[Hashable]] = None
                   ) -> Optional[List[Request]]:
        """Block until a batch is ready. Returns [] when `timeout` elapses
        with nothing to do (so worker loops can poll a stop flag), None
        once the batcher is closed and empty (worker should exit).
        `accept` restricts THIS call to a key set (device-affine
        executors); pending keys outside it neither match nor wake it
        beyond the shared condition's notify."""
        give_up = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                self._expire_locked()
                sel = self._next_key_locked(accept)
                if sel is None:
                    if self._closed:
                        return None
                    if give_up is not None:
                        remaining = give_up - time.monotonic()
                        if remaining <= 0:
                            return []
                        self._cond.wait(remaining)
                    else:
                        self._cond.wait()
                    continue
                cls, key = sel
                # coalesce: wait for the head's key to fill, bounded by the
                # HEAD's age so the first-in request caps the added latency
                full_at = self._queues[cls][key][0].arrival + self.max_wait
                while (not self._closed
                       and key in self._queues[cls]
                       and len(self._queues[cls][key]) < self.max_batch):
                    remaining = full_at - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                    self._expire_locked()
                q = self._queues[cls].get(key)
                if not q:
                    continue   # everything expired or was rejected meanwhile
                batch = []
                while q and len(batch) < self.max_batch:
                    batch.append(q.popleft())
                    self._class_depth[cls] -= 1
                    self._depth -= 1
                if not q:
                    self._drop_key_locked(cls, key)
                return batch

    # -- drain --------------------------------------------------------------

    def close(self) -> int:
        """Stop accepting, reject everything still queued (they were never
        started, so 'rejected cleanly' is accurate), wake all waiters.
        Returns the number of rejected requests. Idempotent."""
        with self._cond:
            if self._closed:
                return 0
            self._closed = True
            rejected = 0
            for cls, queues in self._queues.items():
                for q in queues.values():
                    for r in q:
                        rejected += 1
                        r.future.set_exception(ServiceDraining(
                            "service drained before this request was "
                            "started"))
                queues.clear()
                self._order[cls].clear()
                self._rr[cls] = 0
                self._class_depth[cls] = 0
            self._depth = 0
            self._cond.notify_all()
            return rejected
