"""Shared-memory lane transport: big payloads by descriptor, not by pipe
(a copy of the JAX package's `serve/shmlane.py`; a `threading.Lock`
guards each ring's allocator where the JAX package uses its ranked lock).

A process-entropy-pool task would otherwise round-trip its payload
through a multiprocessing pipe: pickle, copy into a kernel buffer, copy
out, unpickle — two full copies per hop for multi-MB symbol batches,
serialized behind the same file descriptor the *control* traffic rides
on. This module moves the bytes out of band: a fixed set of **lanes**
(fixed-size slots, grouped into size classes sized from the bucket
geometry) lives in one `multiprocessing.shared_memory` segment, the
payload is written into a free lane exactly once, and only a tiny
`LaneRef` descriptor — (ring, class, lane, offset, length) — travels
over the existing pipe. The receiver copies out of the mapped segment
directly.

Discipline, in the same spirit as the DSIM/DSRV stream framing:

* **Every lane is framed**: `[length:u32le][crc:u32le][payload]` with
  the CRC32 chain from utils/integrity.py over (length-field, payload).
  A flipped bit anywhere in the frame fails `verify_crc` and raises the
  same typed `IntegrityError` the stream parsers use — shared memory is
  just another place bytes rot.
* **Geometry liars are caught before the CRC**: the descriptor carries
  the payload length; if the frame header inside the lane disagrees,
  `take()` raises IntegrityError without trusting either number.
* **Oversize or exhausted → per-message fallback**: `put()` returns
  None instead of blocking or tearing; the caller ships the payload
  inline over the pipe exactly as the pipe transport would (typed,
  counted via `serve_shm_fallback_*`). The transport degrades to the
  pipe path message-by-message, never wedges on it.
* **One allocator process per ring, receiver frees**: lane state bytes
  (0 = free, 1 = claimed) live *inside* the segment. Exactly one
  process allocates on a given ring (the service parent for the entropy
  task+reply ring); in-process allocator races are serialized by the
  ring's lock. The *receiver* frees a lane by storing 0 after copy-out
  — a single cross-process byte store. The allocator's free-scan may
  observe a stale 1 (missed free → transient exhaustion → inline
  fallback, benign); it can never observe a false 0, because only the
  receiver writes 0 and only after it is done with the bytes.
* **Creator unlinks**: the creating process owns the segment name and
  is the only one that `unlink()`s. Attaching processes deregister from
  the resource tracker so a dying child cannot tear the segment out
  from under the parent (`SharedMemory(track=False)` arrived only in
  Python 3.13).

Metrics (registered by callers that pass a registry): serve_shm_sends,
serve_shm_bytes, serve_shm_frees, serve_shm_fallbacks plus the split
serve_shm_fallback_oversize / serve_shm_fallback_exhausted reasons.
"""

from __future__ import annotations

import pickle
import secrets
import struct
import threading
from dataclasses import dataclass
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Dict, List, Optional, Sequence, Tuple

from dsin_tpu_torch.utils import faults as faults_lib
from dsin_tpu_torch.utils.integrity import (IntegrityError, frame_crc,
                                            verify_crc)

#: Frame header: payload length (u32le) + CRC32 (u32le).
_HDR = struct.Struct("<II")
FRAME_OVERHEAD = _HDR.size

#: Lane sizes are rounded up to this many bytes.
_LANE_ALIGN = 4096

#: Payloads whose pickle is smaller than this are never worth a lane —
#: the descriptor + copy-out bookkeeping costs more than the pipe.
SMALL_INLINE_MAX = 16384


class ShmLaneError(RuntimeError):
    """A lane-transport invariant was violated (bad descriptor target,
    double free, segment gone). Distinct from IntegrityError, which
    means the *bytes* are suspect rather than the bookkeeping."""


@dataclass(frozen=True)
class LaneClass:
    """One size class inside a ring: `n_lanes` lanes of `lane_bytes`
    payload capacity each (frame overhead is accounted on top)."""

    name: str
    lane_bytes: int
    n_lanes: int

    def __post_init__(self):
        if self.lane_bytes <= 0 or self.n_lanes <= 0:
            raise ValueError(
                f"lane class {self.name!r} must have positive geometry "
                f"(lane_bytes={self.lane_bytes}, n_lanes={self.n_lanes})")


@dataclass(frozen=True)
class LaneRef:
    """Picklable descriptor for one claimed lane: this is what crosses
    the pipe instead of the payload. `offset` addresses the frame start
    inside the segment; `length` is the *payload* length the sender
    wrote (the in-lane header must agree or `take()` refuses)."""

    ring: str
    cls: str
    lane: int
    offset: int
    length: int


def derive_lane_classes(
    byte_bounds: Sequence[Tuple[str, int]], n_lanes: int,
) -> List[LaneClass]:
    """Build lane classes from (name, max_payload_bytes) bounds — one
    class per bucket/bound, each rounded up to the lane alignment, each
    with `n_lanes` lanes. Callers derive `byte_bounds` from the bucket
    geometry (HxWx3 at the widest dtype the results ship)."""
    classes = []
    for name, bound in byte_bounds:
        need = int(bound) + FRAME_OVERHEAD
        size = ((need + _LANE_ALIGN - 1) // _LANE_ALIGN) * _LANE_ALIGN
        classes.append(LaneClass(name, size, max(1, int(n_lanes))))
    return classes


class LaneRing:
    """One shared-memory segment holding every lane of one direction.

    Layout: `[state bytes, one per lane][pad to 64][class0 lanes]
    [class1 lanes]...` — derived deterministically from the class list,
    so `attach()` needs only the manifest (segment name + classes).
    """

    def __init__(self, shm: shared_memory.SharedMemory,
                 classes: Sequence[LaneClass], *, owner: bool,
                 metrics=None):
        self._shm = shm
        self._classes = list(classes)
        self._owner = owner
        self._metrics = metrics
        #: optional `(reason, payload_len) -> None` hook the owner sets
        #: to flight-record fallbacks (metrics alone lose the timeline)
        self.on_fallback = None
        self._closed = False
        # Serializes in-process allocators (claim/free-scan). Cross-
        # process frees bypass it by design — see module docstring.
        self._lock = threading.Lock()
        self._layout: Dict[str, Tuple[int, int, int]] = {}  # name -> (state0, lane0, class)
        state = 0
        data = (sum(c.n_lanes for c in self._classes) + 63) // 64 * 64
        for i, c in enumerate(self._classes):
            self._layout[c.name] = (state, data, i)
            state += c.n_lanes
            data += c.n_lanes * c.lane_bytes
        self._size = data

    # -- construction ---------------------------------------------------

    @classmethod
    def create(cls, name_hint: str, classes: Sequence[LaneClass],
               metrics=None) -> "LaneRing":
        """Create the segment (creator = owner = the only unlinker) and
        zero the lane state bytes."""
        probe = cls(_NullShm(), classes, owner=True)
        # a prefix of the port's own: the JAX package's rings are named
        # "dsin-*", and its tests count those in /dev/shm as leaks
        name = f"dsintorch-{name_hint}-{secrets.token_hex(4)}"
        shm = shared_memory.SharedMemory(
            name=name, create=True, size=max(probe._size, _LANE_ALIGN))
        ring = cls(shm, classes, owner=True, metrics=metrics)
        n_states = sum(c.n_lanes for c in classes)
        shm.buf[:n_states] = bytes(n_states)
        return ring

    @classmethod
    def attach(cls, manifest: Dict[str, Any], metrics=None) -> "LaneRing":
        """Attach to an existing ring from its picklable manifest. The
        attach is deregistered from the resource tracker so this
        process's exit cannot unlink the creator's segment (before 3.13
        there is no SharedMemory(track=False))."""
        shm = shared_memory.SharedMemory(name=manifest["name"], create=False)
        try:  # pragma: no cover - tracker layout is an implementation detail
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        classes = [LaneClass(*c) for c in manifest["classes"]]
        return cls(shm, classes, owner=False, metrics=metrics)

    def set_metrics(self, metrics) -> None:
        """Late-bind a registry (an attaching child builds its service
        — and so its registry — after the ring attach)."""
        self._metrics = metrics

    def manifest(self) -> Dict[str, Any]:
        return {
            "name": self._shm.name,
            "classes": [(c.name, c.lane_bytes, c.n_lanes)
                        for c in self._classes],
        }

    @property
    def name(self) -> str:
        return self._shm.name

    # -- allocation (one allocator process per ring) --------------------

    def claim(self, payload_len: int) -> Optional[LaneRef]:
        """Claim the smallest free lane that fits `payload_len` bytes of
        payload, or None (oversize / exhausted → caller falls back to
        the inline pipe path). Does not write the frame."""
        if self._closed:
            return None
        need = payload_len + FRAME_OVERHEAD
        fits_any = False
        with self._lock:  # guarded-by: self._lock
            buf = self._shm.buf
            for c in self._classes:
                if c.lane_bytes < need:
                    continue
                fits_any = True
                state0, lane0, _ = self._layout[c.name]
                for i in range(c.n_lanes):
                    if buf[state0 + i] == 0:
                        buf[state0 + i] = 1
                        return LaneRef(self._shm.name, c.name, i,
                                       lane0 + i * c.lane_bytes,
                                       payload_len)
        reason = "exhausted" if fits_any else "oversize"
        self._count("serve_shm_fallbacks")
        self._count(f"serve_shm_fallback_{reason}")
        if self.on_fallback is not None:
            self.on_fallback(reason, payload_len)
        return None

    def put(self, data: bytes) -> Optional[LaneRef]:
        """Claim a lane and write the CRC-framed payload into it."""
        ref = self.claim(len(data))
        if ref is None:
            return None
        return self.write_into(ref, data)

    def put_obj(self, obj: Any) -> Optional[LaneRef]:
        """Pickle `obj` into a lane. Small pickles stay inline (None)
        without counting as a fallback — the lane would cost more than
        the pipe for them."""
        blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        if len(blob) < SMALL_INLINE_MAX:
            return None
        return self.put(blob)

    def write_into(self, ref: LaneRef, data: bytes) -> LaneRef:
        """Write the frame for `data` into an already-claimed lane (the
        reply-lane pattern: parent claims, worker writes). Returns a
        descriptor carrying the actual written length."""
        cls = self._class_of(ref)
        if len(data) + FRAME_OVERHEAD > cls.lane_bytes:
            raise ShmLaneError(
                f"payload of {len(data)} B does not fit lane class "
                f"{cls.name!r} ({cls.lane_bytes} B)")
        out = LaneRef(ref.ring, ref.cls, ref.lane, ref.offset, len(data))
        len_field = struct.pack("<I", len(data))
        crc = frame_crc(len_field, data)
        buf = self._shm.buf
        _HDR.pack_into(buf, ref.offset, len(data), crc)
        buf[ref.offset + FRAME_OVERHEAD:
            ref.offset + FRAME_OVERHEAD + len(data)] = data
        self._count("serve_shm_sends")
        self._count("serve_shm_bytes", len(data))
        return out

    # -- receive --------------------------------------------------------

    def take(self, ref: LaneRef, *, free: bool = True) -> bytes:
        """Copy the payload out of a lane, verifying the frame first:
        descriptor/header geometry must agree, then the CRC must hold.
        With `free=True` (receiver side) the lane state byte is released
        after copy-out; pass free=False when the allocator retains
        ownership (entropy task lanes, freed by the parent)."""
        cls = self._class_of(ref)
        if not (0 <= ref.lane < cls.n_lanes):
            raise ShmLaneError(
                f"descriptor names lane {ref.lane} of class {cls.name!r} "
                f"which has only {cls.n_lanes} lanes")
        state0, lane0, _ = self._layout[cls.name]
        offset = lane0 + ref.lane * cls.lane_bytes
        if offset != ref.offset:
            raise IntegrityError(
                f"shm lane {cls.name}[{ref.lane}]: descriptor offset "
                f"{ref.offset} disagrees with ring layout ({offset}) — "
                f"refusing to read through a lying descriptor")
        buf = self._shm.buf
        stored_len, stored_crc = _HDR.unpack_from(buf, offset)
        if stored_len != ref.length:
            raise IntegrityError(
                f"shm lane {cls.name}[{ref.lane}]: frame header claims "
                f"{stored_len} B but the descriptor promised "
                f"{ref.length} B — geometry liar; refusing to trust "
                f"either")
        if stored_len + FRAME_OVERHEAD > cls.lane_bytes:
            raise IntegrityError(
                f"shm lane {cls.name}[{ref.lane}]: frame header claims "
                f"{stored_len} B which overflows the {cls.lane_bytes} B "
                f"lane")
        data = bytes(buf[offset + FRAME_OVERHEAD:
                         offset + FRAME_OVERHEAD + stored_len])
        data = faults_lib.corrupt("serve.shm.lane", data)
        verify_crc(stored_crc, f"shm lane {cls.name}[{ref.lane}]",
                   struct.pack("<I", stored_len), data)
        if free:
            buf[state0 + ref.lane] = 0
            self._count("serve_shm_frees")
        return data

    def take_obj(self, ref: LaneRef, *, free: bool = True) -> Any:
        return pickle.loads(self.take(ref, free=free))

    def free(self, ref: LaneRef) -> None:
        """Release a claimed lane without reading it (send failed, or
        the parent reclaims a task/reply lane after the future settles).
        Idempotent from the sole allocator's point of view."""
        if self._closed:
            return
        cls = self._class_of(ref)
        state0, _, _ = self._layout[cls.name]
        with self._lock:  # guarded-by: self._lock
            self._shm.buf[state0 + ref.lane] = 0
        self._count("serve_shm_frees")

    # -- lifecycle ------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._shm.close()
        except Exception:
            pass

    def unlink(self) -> None:
        """Remove the segment name (creator only; attached processes
        keep valid mappings until they close). Safe to call twice."""
        self.close()
        if not self._owner:
            return
        try:  # pragma: no cover - tracker bookkeeping
            # keep the resource tracker balanced: a same-process attach
            # (tests, benches) unregistered the name; unlink() below
            # unregisters once more, and an unmatched unregister makes
            # the tracker daemon whine at interpreter exit. register()
            # is set-dedup'd, so this is a no-op in the common case.
            resource_tracker.register(self._shm._name, "shared_memory")
        except Exception:
            pass
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass
        except Exception:
            pass

    # -- internals ------------------------------------------------------

    def _class_of(self, ref: LaneRef) -> LaneClass:
        if self._closed:
            raise ShmLaneError("lane ring is closed")
        if ref.ring != self._shm.name:
            raise ShmLaneError(
                f"descriptor is for ring {ref.ring!r}, this is "
                f"{self._shm.name!r}")
        entry = self._layout.get(ref.cls)
        if entry is None:
            raise ShmLaneError(f"unknown lane class {ref.cls!r}")
        return self._classes[entry[2]]

    def _count(self, name: str, n: int = 1) -> None:
        if self._metrics is not None:
            self._metrics.counter(name).inc(n)


class _NullShm:
    """Size-probe stand-in so LaneRing.__init__ can compute the layout
    before the real segment exists."""

    name = "<probe>"
    buf = memoryview(b"")

    def close(self):
        pass
