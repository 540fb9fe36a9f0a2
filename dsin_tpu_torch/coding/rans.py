"""rANS entropy coder: ctypes bindings to the native coder, and its plain
Python version (counterpart of the JAX package's `coding/rans.py`).

The native coder is `csrc/range_coder.cpp`, a byte-for-byte copy of the JAX
package's `coding/native/range_coder.cpp` (its header gives the algorithm
and the stream layout). `load_library` builds it with g++ at first use into
`build/` (`native_build`), keyed by a hash of the source and flags, and
raises when the build or the load fails: there is no silent fallback. The pure-Python coder
(`encode_py`, `PyDecoder`) implements the identical integer algorithm; it
is the plain version the tests hold the native one against, and no entry
point calls it.

`native_call_counts` counts the calls that crossed into the C library, per
entry point.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence

import numpy as np

from dsin_tpu_torch import native_build

RANS_L = 1 << 23
DEFAULT_SCALE_BITS = 16

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "range_coder.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_counts_lock = threading.Lock()
_native_calls: Dict[str, int] = {}


def _count(name: str) -> None:
    with _counts_lock:
        _native_calls[name] = _native_calls.get(name, 0) + 1


def native_call_counts() -> Dict[str, int]:
    """{entry point: native calls since the last reset}."""
    with _counts_lock:
        return dict(_native_calls)


def reset_native_call_counts() -> None:
    with _counts_lock:
        _native_calls.clear()


class RansCapacityError(RuntimeError):
    """The native encoder overflowed its output buffer even after the
    doubled-cap retries: the stream expanded past every offered capacity."""


class CoderLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: str
    build_seconds: float       # 0.0 when the library was already built


@functools.lru_cache(maxsize=None)
def load_library() -> CoderLibrary:
    """Build `csrc/range_coder.cpp` into `build/` (keyed by a hash of the
    source and flags) unless already built, and bind it. Raises on
    failure."""
    so, seconds, _ = native_build.build(SOURCE, native_build.gxx(),
                                        GXX_FLAGS, "range_coder")
    lib = ctypes.CDLL(str(so))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_long)
    vp, lg, i32 = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    for name, restype, argtypes in (
            ("rans_encode", lg, [u32p, u32p, lg, i32, u8p, lg]),
            ("rans_encode_batch", lg,
             [u32p, u32p, i64p, lg, i32, u8p, i64p, i64p]),
            ("rans_decoder_new", vp, [u8p, lg]),
            ("rans_decoder_peek", ctypes.c_uint32, [vp, i32]),
            ("rans_decoder_advance", None,
             [vp, ctypes.c_uint32, ctypes.c_uint32, i32]),
            ("rans_decoder_free", None, [vp]),
            ("rans_decode_static", None, [vp, u32p, i32, lg, i32, i32p]),
            ("rans_decode_front", None, [vp, u32p, lg, i32, i32, i32p]),
            ("rans_decode_batch", None,
             [ctypes.POINTER(vp), u32p, i64p, lg, i32, i32, i32p])):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return CoderLibrary(lib, str(so), seconds)


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# -- encode -------------------------------------------------------------------

def encode_py(starts: Sequence[int], freqs: Sequence[int],
              scale_bits: int = DEFAULT_SCALE_BITS) -> bytes:
    """The plain version of `encode`: the same integer algorithm in
    Python, byte-identical streams."""
    out = bytearray()
    x = RANS_L
    shift = (RANS_L >> scale_bits) << 8
    for i in range(len(starts) - 1, -1, -1):
        freq = int(freqs[i])
        x_max = shift * freq
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        x = ((x // freq) << scale_bits) + (x % freq) + int(starts[i])
    head = bytes((x & 0xFF, (x >> 8) & 0xFF, (x >> 16) & 0xFF,
                  (x >> 24) & 0xFF))
    return head + bytes(reversed(out))


#: capacity-retry policy of the native encoder: start from `_encode_cap(n)`
#: (8 bytes a symbol + flush, about 4x the true worst case) and double up
#: to this many times before raising RansCapacityError
_CAP_DOUBLINGS = 4


def _encode_cap(n: int) -> int:
    """Initial output capacity for an n-symbol lane (bytes)."""
    return 8 * n + 64


def _validate_lane(starts: np.ndarray, freqs: np.ndarray) -> None:
    if starts.shape != freqs.shape or starts.ndim != 1:
        raise ValueError(f"starts/freqs mismatch: {starts.shape} vs "
                         f"{freqs.shape}")
    if len(freqs) and int(freqs.min()) < 1:
        # freq = 0 would be an unencodable symbol (and an integer division
        # by zero in the native coder)
        raise ValueError("all frequencies must be >= 1")


def encode(starts: Sequence[int], freqs: Sequence[int],
           scale_bits: int = DEFAULT_SCALE_BITS) -> bytes:
    """Encode n symbols given per-symbol cumulative start and frequency
    (forward order). freq must be >= 1 and start+freq <= 1<<scale_bits."""
    starts = np.ascontiguousarray(starts, dtype=np.uint32)
    freqs = np.ascontiguousarray(freqs, dtype=np.uint32)
    _validate_lane(starts, freqs)
    lib = load_library().lib
    cap = _encode_cap(len(starts))
    for _ in range(_CAP_DOUBLINGS + 1):
        out = np.empty(cap, dtype=np.uint8)
        _count("encode")
        n = lib.rans_encode(_ptr(starts, ctypes.c_uint32),
                            _ptr(freqs, ctypes.c_uint32), len(starts),
                            scale_bits, _ptr(out, ctypes.c_uint8), cap)
        if n >= 0:
            return out[:n].tobytes()
        if n == -2:
            # a doubled buffer would only deepen the OOM
            raise MemoryError("rans_encode: native scratch allocation "
                              "failed")
        # -1: the cap was too small; the retry re-encodes from scratch, so
        # the stream is what a large-enough first cap would have produced
        cap *= 2
    raise RansCapacityError(
        f"rans_encode overflowed a {cap // 2}-byte buffer for "
        f"{len(starts)} symbols after {_CAP_DOUBLINGS} doublings")


def encode_batch(starts_list: Sequence[np.ndarray],
                 freqs_list: Sequence[np.ndarray],
                 scale_bits: int = DEFAULT_SCALE_BITS) -> List[bytes]:
    """Encode N independent symbol lanes in ONE native call. Lanes may be
    ragged (empty lanes are legal); the streams are byte-identical to N
    separate `encode` calls."""
    if len(starts_list) != len(freqs_list):
        raise ValueError(f"{len(starts_list)} starts lanes vs "
                         f"{len(freqs_list)} freqs lanes")
    lanes = [(np.ascontiguousarray(s, dtype=np.uint32),
              np.ascontiguousarray(f, dtype=np.uint32))
             for s, f in zip(starts_list, freqs_list)]
    for s, f in lanes:
        _validate_lane(s, f)
    if not lanes:
        return []
    lib = load_library().lib
    i64 = ctypes.c_long
    offsets = np.zeros(len(lanes) + 1, dtype=np.int64)
    np.cumsum([len(s) for s, _ in lanes], out=offsets[1:])
    starts = np.concatenate([s for s, _ in lanes] + [np.zeros(0, np.uint32)])
    freqs = np.concatenate([f for _, f in lanes] + [np.zeros(0, np.uint32)])
    # per-lane capacity sized by the lane's own length; on overflow only
    # the guilty lane's cap doubles
    caps = np.array([_encode_cap(len(s)) for s, _ in lanes], dtype=np.int64)
    doublings = np.zeros(len(lanes), dtype=np.int64)
    while True:
        out_offsets = np.zeros(len(lanes) + 1, dtype=np.int64)
        np.cumsum(caps, out=out_offsets[1:])
        out = np.empty(int(out_offsets[-1]), dtype=np.uint8)
        sizes = np.zeros(len(lanes), dtype=np.int64)
        _count("encode_batch")
        rc = lib.rans_encode_batch(
            _ptr(starts, ctypes.c_uint32), _ptr(freqs, ctypes.c_uint32),
            _ptr(offsets, i64), len(lanes), scale_bits,
            _ptr(out, ctypes.c_uint8), _ptr(out_offsets, i64),
            _ptr(sizes, i64))
        if rc == 0:
            return [out[out_offsets[i]:out_offsets[i] + int(sizes[i])]
                    .tobytes() for i in range(len(lanes))]
        if rc == -(len(lanes) + 1):
            raise MemoryError("rans_encode_batch: native scratch "
                              "allocation failed")
        guilty = -int(rc) - 1
        if doublings[guilty] >= _CAP_DOUBLINGS:
            raise RansCapacityError(
                f"rans_encode_batch overflowed a {int(caps[guilty])}-byte "
                f"lane buffer (lane {guilty} of {len(lanes)}) after "
                f"{_CAP_DOUBLINGS} doublings")
        caps[guilty] *= 2
        doublings[guilty] += 1


# -- decode -------------------------------------------------------------------

class _DecoderBase:
    """peek() gives the cumulative-frequency value of the next symbol; the
    caller resolves it against its own cumulative table and calls
    advance(start, freq). The split lets an autoregressive model supply a
    fresh PMF per position."""

    scale_bits: int

    def peek(self) -> int:
        raise NotImplementedError

    def advance(self, start: int, freq: int) -> None:
        raise NotImplementedError

    def decode_symbol(self, cum: np.ndarray) -> int:
        """Resolve + consume one symbol against cumulative table `cum`
        (length L+1, cum[L] == 1<<scale_bits)."""
        cf = self.peek()
        s = int(np.searchsorted(cum, cf, side="right")) - 1
        self.advance(int(cum[s]), int(cum[s + 1] - cum[s]))
        return s

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PyDecoder(_DecoderBase):
    """The plain version of `Decoder`: the same integer algorithm in
    Python."""

    def __init__(self, data: bytes, scale_bits: int = DEFAULT_SCALE_BITS):
        if len(data) < 4:
            raise ValueError("truncated rANS stream (< 4 bytes)")
        self.scale_bits = scale_bits
        self._data = bytes(data)
        self._state = int.from_bytes(self._data[:4], "little")
        self._pos = 4

    def peek(self) -> int:
        return self._state & ((1 << self.scale_bits) - 1)

    def advance(self, start: int, freq: int) -> None:
        mask = (1 << self.scale_bits) - 1
        x = freq * (self._state >> self.scale_bits) \
            + (self._state & mask) - start
        while x < RANS_L and self._pos < len(self._data):
            x = (x << 8) | self._data[self._pos]
            self._pos += 1
        self._state = x

    def decode_front(self, cums: np.ndarray) -> np.ndarray:
        return np.array([self.decode_symbol(c) for c in cums],
                        dtype=np.int32)

    def decode_static(self, cum: np.ndarray, n: int) -> np.ndarray:
        return np.array([self.decode_symbol(cum) for _ in range(n)],
                        dtype=np.int32)


class Decoder(_DecoderBase):
    """Sequential rANS decoder over one bitstream, in the native coder."""

    def __init__(self, data: bytes, scale_bits: int = DEFAULT_SCALE_BITS):
        if len(data) < 4:
            raise ValueError("truncated rANS stream (< 4 bytes)")
        self.scale_bits = scale_bits
        self._lib = load_library().lib
        self._buf = np.frombuffer(data, dtype=np.uint8)
        self._handle = self._lib.rans_decoder_new(
            _ptr(self._buf, ctypes.c_uint8), len(data))
        if not self._handle:
            raise ValueError("rANS decoder rejected the stream")

    def peek(self) -> int:
        return int(self._lib.rans_decoder_peek(self._handle,
                                               self.scale_bits))

    def advance(self, start: int, freq: int) -> None:
        self._lib.rans_decoder_advance(self._handle, start, freq,
                                       self.scale_bits)

    def decode_front(self, cums: np.ndarray) -> np.ndarray:
        """Decode one symbol per row of `cums` ((n, L+1) cumulative tables,
        one fresh adaptive table per symbol) in one native call: the
        wavefront hot path."""
        cums = np.ascontiguousarray(cums, dtype=np.uint32)
        out = np.empty(cums.shape[0], dtype=np.int32)
        _count("decode_front")
        self._lib.rans_decode_front(
            self._handle, _ptr(cums, ctypes.c_uint32), cums.shape[0],
            cums.shape[1] - 1, self.scale_bits, _ptr(out, ctypes.c_int32))
        return out

    def decode_static(self, cum: np.ndarray, n: int) -> np.ndarray:
        """Decode n symbols sharing one cumulative table."""
        cum = np.ascontiguousarray(cum, dtype=np.uint32)
        out = np.empty(n, dtype=np.int32)
        _count("decode_static")
        self._lib.rans_decode_static(
            self._handle, _ptr(cum, ctypes.c_uint32), len(cum) - 1, n,
            self.scale_bits, _ptr(out, ctypes.c_int32))
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.rans_decoder_free(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


def decode_front_batch(decoders: Sequence[Decoder],
                       cums_list: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Advance N independent native decoders one wavefront each in ONE
    native call. `cums_list[i]` is decoder i's (k_i, L+1) adaptive
    cumulative tables; lanes may be ragged and k_i = 0 is legal. Per-lane
    results are identical to N separate `decode_front` calls."""
    if len(decoders) != len(cums_list):
        raise ValueError(f"{len(decoders)} decoders vs {len(cums_list)} "
                         f"cum-table lanes")
    if not all(isinstance(d, Decoder) for d in decoders):
        raise TypeError("decode_front_batch takes native Decoders only")
    if not decoders:
        return []
    cums = [np.ascontiguousarray(c, dtype=np.uint32) for c in cums_list]
    widths = {c.shape[1] for c in cums if len(c)}
    if len(widths) > 1:
        raise ValueError(f"lanes disagree on table width: {sorted(widths)}")
    scale_bits = decoders[0].scale_bits
    if any(d.scale_bits != scale_bits for d in decoders):
        raise ValueError("decoders disagree on scale_bits")
    if not widths:
        return [np.empty(0, dtype=np.int32) for _ in decoders]
    num_syms = next(iter(widths)) - 1
    offsets = np.zeros(len(cums) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in cums], out=offsets[1:])
    packed = np.ascontiguousarray(np.concatenate(
        [c.reshape(-1, num_syms + 1) for c in cums], axis=0))
    handles = (ctypes.c_void_p * len(decoders))(
        *[d._handle for d in decoders])
    out = np.empty(int(offsets[-1]), dtype=np.int32)
    _count("decode_batch")
    decoders[0]._lib.rans_decode_batch(
        handles, _ptr(packed, ctypes.c_uint32), _ptr(offsets, ctypes.c_long),
        len(decoders), num_syms, scale_bits, _ptr(out, ctypes.c_int32))
    return [out[offsets[i]:offsets[i + 1]] for i in range(len(decoders))]


# -- pmf quantization ---------------------------------------------------------

def quantize_pmf(pmf: np.ndarray,
                 scale_bits: int = DEFAULT_SCALE_BITS) -> np.ndarray:
    """Deterministically quantize a float PMF to integer frequencies summing
    to 1<<scale_bits, every entry >= 1 (so any symbol stays decodable)."""
    total = 1 << scale_bits
    pmf = np.asarray(pmf, dtype=np.float64)
    pmf = np.maximum(pmf, 0.0)
    norm = pmf.sum()
    if not np.isfinite(norm) or norm <= 0:
        pmf = np.ones_like(pmf)
        norm = pmf.sum()
    freqs = np.floor(pmf / norm * total).astype(np.int64)
    freqs = np.maximum(freqs, 1)
    # deterministic fix-up of the rounding drift: push the difference onto
    # the largest bins (ties -> lowest index via argmax), never below 1
    diff = total - int(freqs.sum())
    while diff != 0:
        if diff > 0:
            freqs[int(np.argmax(freqs))] += diff
            diff = 0
        else:
            i = int(np.argmax(freqs))
            take = min(-diff, int(freqs[i]) - 1)
            if take == 0:
                raise ValueError("cannot satisfy min-frequency constraint")
            freqs[i] -= take
            diff += take
    return freqs.astype(np.uint32)


def quantize_pmf_batch(pmfs: np.ndarray,
                       scale_bits: int = DEFAULT_SCALE_BITS) -> np.ndarray:
    """Row-wise `quantize_pmf` over (B, L) PMFs, bit-identical results: the
    common path (floor + clamp, positive drift onto the argmax bin) is
    vectorized; rows needing the negative-drift loop take the scalar
    function."""
    total = 1 << scale_bits
    pmfs = np.asarray(pmfs, dtype=np.float64)
    pmfs = np.maximum(pmfs, 0.0)
    norm = pmfs.sum(axis=1, keepdims=True)
    bad = ~np.isfinite(norm[:, 0]) | (norm[:, 0] <= 0)
    if bad.any():
        pmfs = pmfs.copy()
        pmfs[bad] = 1.0
        norm = pmfs.sum(axis=1, keepdims=True)
    freqs = np.floor(pmfs / norm * total).astype(np.int64)
    freqs = np.maximum(freqs, 1)
    diff = total - freqs.sum(axis=1)
    pos = diff > 0
    if pos.any():
        rows = np.flatnonzero(pos)
        freqs[rows, np.argmax(freqs[rows], axis=1)] += diff[rows]
    for r in np.flatnonzero(diff < 0):
        freqs[r] = quantize_pmf(pmfs[r], scale_bits)
    return freqs.astype(np.uint32)


def cum_from_freqs_batch(freqs: np.ndarray) -> np.ndarray:
    """Row-wise `cum_from_freqs`: (B, L) -> (B, L+1) uint32."""
    freqs = np.asarray(freqs, dtype=np.uint64)
    out = np.zeros((freqs.shape[0], freqs.shape[1] + 1), dtype=np.uint64)
    np.cumsum(freqs, axis=1, out=out[:, 1:])
    return out.astype(np.uint32)


def cum_from_freqs(freqs: np.ndarray) -> np.ndarray:
    """Cumulative table (L+1,) from frequencies (L,)."""
    cum = np.zeros(len(freqs) + 1, dtype=np.uint32)
    np.cumsum(freqs, out=cum[1:])
    return cum
