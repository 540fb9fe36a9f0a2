"""Device placement for the serve bucket ladder (a copy of the JAX
package's `serve/placement.py` without JAX).

The static shape-bucket ladder (`serve/buckets.py`) is mapped onto the
service's serve devices, and micro-batches dispatch data-parallel WITHIN a
bucket by running concurrently on the bucket's replica devices.

Two layers:

* **Policy** (`plan_placement` -> `PlacementPlan`, `RebalanceTrigger`):
  pure and deterministic, copied as they are. Each bucket's replica count
  is proportional to its traffic weight, replicas pack onto the
  least-loaded devices, every bucket is served by >= 1 device and every
  device serves >= 1 bucket.

* **Runtime** (`DevicePlacement`): the serve devices as a tuple of
  `torch.device`s and the live plan, swapped atomically under a lock so a
  rebalance never tears the routing table under a running executor.
  `put_batch(d, x)` moves a host batch onto device `d`, `replicate(d,
  model)` gives device `d` its own copy of the weights.

Logical devices (port only): the JAX package gets N devices on one host
from XLA's forced host devices; here `ServiceConfig.devices` is either an
int, the first N visible devices of the service's device type, or a tuple
of device strings in which a repeat is allowed: `("cpu",) * 4` on the CPU,
`("cuda:0", "cuda:0")` for two logical serve devices on one card. Each
logical device holds its own weights (`replicate` copies even onto the
same physical device) and its own worker streams, so the code path is the
one that two cards take. An int beyond the visible count raises typed
`PlacementError`; nothing falls back silently.

Executable-census contract: as in the JAX package, every (bucket, device)
pair of the plan is warmed (`CompressionService.warmup`) and a rebalance
warms the pairs new to its plan before it swaps the plan in, so the
census is `2 * sum(len(replicas))` and no request finds a cold pair.

Data parallelism is at micro-batch granularity: each batch runs whole on
one device, the same device functions on a copy of the same weights, so
results are bit-identical to the single-device path.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Bucket = Tuple[int, int]


class PlacementError(ValueError):
    """A placement request the planner cannot honor (bad device count,
    unknown bucket in the weight map, negative weight) — typed so the
    serve door / CLI can answer it readably instead of asserting."""


def _bucket_key(bucket: Bucket) -> str:
    return f"{bucket[0]}x{bucket[1]}"


@dataclass(frozen=True)
class PlacementPlan:
    """Immutable bucket -> replica-device-set assignment.

    `assignments` maps each bucket to a sorted tuple of device INDICES
    (positions in the serve device list; the runtime owns the index ->
    device binding). `weights` records the traffic weights the plan was
    computed from, so a rebalance diff is auditable.
    """

    num_devices: int
    assignments: Mapping[Bucket, Tuple[int, ...]]
    weights: Mapping[Bucket, float] = field(default_factory=dict)

    def devices_for(self, bucket: Bucket) -> Tuple[int, ...]:
        try:
            return self.assignments[tuple(bucket)]
        except KeyError:
            raise PlacementError(
                f"bucket {tuple(bucket)} is not in the placement plan "
                f"(buckets: {sorted(self.assignments)})") from None

    def buckets_for(self, device: int) -> Tuple[Bucket, ...]:
        return tuple(b for b, devs in sorted(self.assignments.items())
                     if device in devs)

    def census(self) -> Tuple[Tuple[Bucket, int], ...]:
        """Every (bucket, device) pair the plan can route to."""
        return tuple((b, d) for b, devs in sorted(self.assignments.items())
                     for d in devs)

    def as_dict(self) -> Dict[str, list]:
        """JSON-able census for /metrics: {"128x256": [0, 1], ...}."""
        return {_bucket_key(b): list(devs)
                for b, devs in sorted(self.assignments.items())}


def plan_placement(buckets: Sequence[Bucket], num_devices: int,
                   weights: Optional[Mapping[Bucket, float]] = None
                   ) -> PlacementPlan:
    """Deterministic ladder -> device assignment.

    Replica counts are proportional to weight share (at least 1, at most
    `num_devices`); replicas then pack greedily onto the least-loaded
    device not already hosting that bucket, heaviest bucket first, so
    hot buckets spread across devices while cold buckets pile onto
    whichever device has headroom. Devices the greedy pass left empty
    adopt an extra replica of the bucket with the highest per-replica
    load — every device always serves >= 1 bucket. Ties break by index,
    so the same inputs always produce the same plan.
    """
    bl = [tuple(b) for b in buckets]
    if not bl:
        raise PlacementError("cannot place an empty bucket ladder")
    if len(set(bl)) != len(bl):
        raise PlacementError(f"duplicate buckets in ladder: {bl}")
    if num_devices < 1:
        raise PlacementError(
            f"need at least one device, got num_devices={num_devices}")
    if weights is None:
        w = {b: 1.0 for b in bl}
    else:
        wmap = {tuple(k): float(v) for k, v in weights.items()}
        unknown = sorted(set(wmap) - set(bl))
        if unknown:
            raise PlacementError(
                f"weights name buckets outside the ladder: {unknown}")
        if any(v < 0 for v in wmap.values()):
            raise PlacementError(f"negative bucket weight in {wmap}")
        w = {b: wmap.get(b, 1.0) for b in bl}
    total = sum(w.values())
    if total <= 0:          # all-zero weights degrade to uniform
        w = {b: 1.0 for b in bl}
        total = float(len(bl))

    reps = {b: min(num_devices,
                   max(1, round(num_devices * w[b] / total)))
            for b in bl}
    load = [0.0] * num_devices
    assign: Dict[Bucket, list] = {b: [] for b in bl}
    for b in sorted(bl, key=lambda bb: (-w[bb], bb)):
        share = w[b] / reps[b]
        for _ in range(reps[b]):
            d = min((d for d in range(num_devices) if d not in assign[b]),
                    key=lambda dd: (load[dd], dd))
            assign[b].append(d)
            load[d] += share
    for d in range(num_devices):
        if any(d in devs for devs in assign.values()):
            continue
        b = max((bb for bb in bl if d not in assign[bb]),
                key=lambda bb: (w[bb] / len(assign[bb]), bb))
        assign[b].append(d)
        load[d] += w[b] / len(assign[b])
    return PlacementPlan(
        num_devices=num_devices,
        assignments={b: tuple(sorted(devs)) for b, devs in assign.items()},
        weights=dict(w))


class RebalanceTrigger:
    """Load-aware automatic rebalance decision.

    Pure windowed policy, no locks: the caller (the service supervisor
    thread) feeds it CUMULATIVE per-bucket request counts each check; the
    trigger differences them into a window, computes the skew

        skew = (max bucket share in the window) / (uniform share)

    and fires — returning the +1-smoothed window counts as the weights
    to re-plan with — only when the skew has been >= `skew_threshold`
    for `hysteresis_checks` CONSECUTIVE windows AND at least
    `cooldown_s` has passed since the last fire (no flapping: each
    rebalance warms pairs).

    Windows with fewer than `min_window_requests` total requests are
    skipped entirely and RESET the streak.
    """

    def __init__(self, skew_threshold: float = 2.0,
                 hysteresis_checks: int = 2, cooldown_s: float = 60.0,
                 min_window_requests: int = 16):
        if skew_threshold < 1.0:
            raise PlacementError(
                f"skew_threshold must be >= 1 (uniform traffic has skew "
                f"1.0), got {skew_threshold}")
        if hysteresis_checks < 1:
            raise PlacementError(
                f"hysteresis_checks must be >= 1, got {hysteresis_checks}")
        if cooldown_s < 0 or min_window_requests < 1:
            raise PlacementError(
                f"bad trigger config: cooldown_s={cooldown_s}, "
                f"min_window_requests={min_window_requests}")
        self.skew_threshold = float(skew_threshold)
        self.hysteresis_checks = int(hysteresis_checks)
        self.cooldown_s = float(cooldown_s)
        self.min_window_requests = int(min_window_requests)
        self._last_counts: Dict[Bucket, int] = {}
        self._streak = 0
        self._last_fire: Optional[float] = None
        #: most recent window's skew (1.0 = uniform; gauge fodder)
        self.last_skew = 1.0

    def observe(self, now: float, counts: Mapping[Bucket, int]
                ) -> Optional[Dict[Bucket, float]]:
        """One supervisor check. `counts` are cumulative per-bucket
        request totals; returns the weight map to pass to
        `rebalance_placement(weights=...)` when a rebalance should
        happen NOW, else None."""
        window = {tuple(b): max(0, int(c) - self._last_counts.get(
            tuple(b), 0)) for b, c in counts.items()}
        self._last_counts = {tuple(b): int(c) for b, c in counts.items()}
        total = sum(window.values())
        if not window or total < self.min_window_requests:
            self._streak = 0
            return None
        self.last_skew = (max(window.values()) / total) * len(window)
        if self.last_skew < self.skew_threshold:
            self._streak = 0
            return None
        self._streak += 1
        if self._streak < self.hysteresis_checks:
            return None
        if (self._last_fire is not None
                and now - self._last_fire < self.cooldown_s):
            return None
        self._last_fire = now
        self._streak = 0
        return {b: 1.0 + c for b, c in window.items()}


def visible_devices(device: torch.device) -> Tuple[torch.device, ...]:
    """The devices of `device`'s type this process can see: every card on
    "cuda", the one CPU on "cpu"."""
    if device.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device(device.type),)


def serve_devices(spec, device: torch.device) -> Tuple[torch.device, ...]:
    """`ServiceConfig.devices` -> the serve devices. None is one device,
    `device` itself; an int N the first N visible devices of `device`'s
    type; a tuple of device strings names each logical device, a repeat
    allowed. A count or an index beyond what is visible raises typed
    PlacementError."""
    if spec is None:
        return (device,)
    if isinstance(spec, (int, np.integer)) and not isinstance(spec, bool):
        n = int(spec)
        if n < 1:
            raise PlacementError(f"num_devices must be >= 1, got {n}")
        visible = visible_devices(device)
        if n > len(visible):
            raise PlacementError(
                f"requested {n} serve devices but only {len(visible)} "
                f"{device.type} devices are visible — name logical devices "
                f"with a tuple instead, a repeat allowed (e.g. "
                f"devices=({str(visible[0])!r},) * {n})")
        return visible[:n]
    if isinstance(spec, str) or not isinstance(spec, Sequence) or not spec:
        raise PlacementError(
            f"devices must be None, an int or a non-empty tuple of device "
            f"strings, got {spec!r}")
    out = []
    for name in spec:
        dev = torch.device(name)
        if dev.type == "cuda":
            index = 0 if dev.index is None else dev.index
            if index >= torch.cuda.device_count():
                raise PlacementError(
                    f"serve device {name!r} is not visible "
                    f"({torch.cuda.device_count()} cuda devices)")
            dev = torch.device("cuda", index)
        out.append(dev)
    return tuple(out)


def device_count(spec) -> int:
    """Logical serve devices a `ServiceConfig.devices` value names,
    without resolving them (None = 1)."""
    if spec is None:
        return 1
    if isinstance(spec, (int, np.integer)) and not isinstance(spec, bool):
        return max(1, int(spec))
    return max(1, len(spec))


def to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host batch onto `dev`: on a card through pinned memory, a copy
    ordered on the caller's current stream that does not block the
    host."""
    t = torch.from_numpy(arr)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


class DevicePlacement:
    """The live routing table plus the serve devices.

    `devices` lists the devices to serve on (`serve_devices`' tuple: the
    visible ones, or logical devices); every one of them serves. Plan
    reads and swaps go through one lock so executors always see a
    complete table; callers get immutable snapshots and never hold the
    lock across device work.
    """

    def __init__(self, buckets: Sequence[Bucket], *, devices: Sequence,
                 weights: Optional[Mapping[Bucket, float]] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.num_devices = len(self.devices)
        self._lock = threading.Lock()
        # guarded-by: self._lock
        self._plan = plan_placement(buckets, self.num_devices, weights)

    # -- plan access ---------------------------------------------------------

    @property
    def plan(self) -> PlacementPlan:
        with self._lock:
            return self._plan

    def devices_for(self, bucket: Bucket) -> Tuple[int, ...]:
        with self._lock:
            return self._plan.devices_for(bucket)

    def buckets_for(self, device: int) -> Tuple[Bucket, ...]:
        with self._lock:
            return self._plan.buckets_for(device)

    def set_plan(self, plan: PlacementPlan) -> bool:
        """Swap the live routing table; returns whether it changed.
        Callers (service rebalance) must have warmed every pair new to
        `plan` BEFORE swapping."""
        if plan.num_devices != self.num_devices:
            raise PlacementError(
                f"plan spans {plan.num_devices} devices; this placement "
                f"runs {self.num_devices}")
        with self._lock:
            if set(plan.assignments) != set(self._plan.assignments):
                raise PlacementError(
                    "plan bucket set does not match the serve ladder")
            changed = plan.assignments != self._plan.assignments
            self._plan = plan
        return changed

    # -- device-side placement ----------------------------------------------

    def put_batch(self, device: int, array: np.ndarray) -> torch.Tensor:
        """Host batch -> serve device `device` (`to_device`): asynchronous
        on a card, ordered on the caller's current stream."""
        return to_device(array, self.devices[device])

    def replicate(self, device: int, model: torch.nn.Module
                  ) -> torch.nn.Module:
        """Device `device`'s own copy of `model`'s weights: a deep copy
        moved there, never a shared storage, even when two logical
        devices name one physical device."""
        return copy.deepcopy(model).to(self.devices[device])

    def __repr__(self) -> str:
        return (f"DevicePlacement(num_devices={self.num_devices}, "
                f"devices={[str(d) for d in self.devices]}, "
                f"plan={self.plan.as_dict()})")
