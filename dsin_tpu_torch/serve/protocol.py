"""Replica pipe protocol (a copy of the JAX package's `serve/protocol.py`):
the ONE place the front door's wire tuples are built and read. The router
parent and the replica child (`serve/router.py`) both import these
helpers; neither touches tuple indices directly, so a payload encoded as
a shm `LaneRef` descriptor (`serve/shmlane.py`) at one site is parsed by
the same rules at the other.

Wire shapes (unchanged from the pre-shm protocol — the descriptor rides
in the payload SLOT, never a new tuple shape):

    request:  (op, rid, payload, priority, deadline_ms, trace)
    control:  (op, rid, payload, None, None)          # swap/rollback
    stop:     ("stop", None, None, None, None)
    answer:   (tag, rid, payload)    # "ready"/"failed"/"ok"/"err"/"bye"

Payload encoding: `wire_payload(ring, obj)` returns a LaneRef when the
ring accepts the pickled object into a lane (big enough to be worth it,
a lane free), else the object itself — the per-message inline fallback
IS the pipe path, bit-for-bit. `resolve_payload(ring, obj)` inverts it
on the receiving side; resolving a descriptor without a ring is a typed
refusal, never a silent pass-through of the wrong type.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from dsin_tpu_torch.serve import shmlane

#: pipe ops that drive the two-phase hot swap instead of carrying a
#: request; they target a SPECIFIC replica and are never rerouted on
#: death — a dead replica fails its swap phase, typed
CONTROL_OPS = frozenset(
    {"swap_prepare", "swap_commit", "swap_abort", "rollback"})

#: ops that carry a request payload eligible for the lane transport
REQUEST_OPS = frozenset({"encode", "decode", "decode_si"})

SESSION_OPS = frozenset({"session_open", "session_close"})

STOP = "stop"


def stop_msg() -> Tuple:
    """The graceful-shutdown frame (always inline, always tiny)."""
    return (STOP, None, None, None, None)


def control_msg(op: str, rid: int, payload: Any) -> Tuple:
    """A swap-phase/session control frame: 5-tuple, no deadline, no
    trace, payload always inline (digests and paths, never images)."""
    return (op, rid, payload, None, None)


def request_msg(op: str, rid: int, payload: Any,
                priority: Optional[str], deadline_ms: Optional[float],
                trace) -> Tuple:
    """A routed request frame. `payload` may be the object itself or a
    LaneRef from `wire_payload` — the tuple shape does not change."""
    return (op, rid, payload, priority, deadline_ms, trace)


def parse_request(msg: Tuple):
    """Child-side parse -> (op, rid, payload, priority, deadline_ms,
    trace). Control frames parse through the same shape (their last two
    slots are None and they carry no trace)."""
    op, rid, payload, priority, deadline_ms = msg[:5]
    trace = msg[5] if len(msg) > 5 else None
    return op, rid, payload, priority, deadline_ms, trace


def wire_payload(ring: Optional[shmlane.LaneRing], obj: Any) -> Any:
    """Encode one payload for the pipe: into a shm lane when the ring
    takes it (returns the LaneRef descriptor), else the object itself.
    A None ring is the pipe transport — always inline. Never raises on
    lane pressure; exhaustion/oversize fall back inline by contract."""
    if ring is None:
        return obj
    ref = ring.put_obj(obj)
    return obj if ref is None else ref


def resolve_payload(ring: Optional[shmlane.LaneRing], obj: Any,
                    *, free: bool = True) -> Any:
    """Decode one payload off the pipe: a LaneRef copies out of the
    ring (CRC-verified, lane freed unless the sender retains it), any
    other object IS the payload. Raises ShmLaneError on a descriptor
    with no ring to resolve it against — that is protocol drift, not a
    payload."""
    if not isinstance(obj, shmlane.LaneRef):
        return obj
    if ring is None:
        raise shmlane.ShmLaneError(
            "received a shm lane descriptor on a pipe-transport "
            "connection — sender and receiver disagree about the "
            "transport")
    return ring.take_obj(obj, free=free)
