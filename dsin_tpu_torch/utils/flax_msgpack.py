"""flax's msgpack checkpoint format, read and written by hand (counterpart of
`flax.serialization.msgpack_serialize` / `msgpack_restore`).

The JAX package writes every checkpoint partition with flax
(`train/checkpoint.py _write_msgpack`): the tree goes through
`to_state_dict` and is packed with `strict_types=True`, arrays as msgpack
extension types. The card machine has neither flax nor the `msgpack`
package, so this module implements the subset of msgpack those files use.

Format (what flax writes and reads):
  * maps with str keys, nested (a list or tuple is written as the map of
    its indices, as `to_state_dict` stores it); python scalars (nil, bool,
    int, float, str, bytes);
  * ext type 1 (`ndarray`): the payload is itself a msgpack array
    ``[shape, dtype.name, raw C-order bytes]``;
  * ext type 3 (`npscalar`): the same payload for a 0-d array, read back as
    a numpy scalar;
  * ext type 2 (`native_complex`): ``[real, imag]``;
  * arrays above 2**30 bytes are stored in flax's chunked form, a map
    ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
    "chunks": {"0": flat_chunk, ...}}``; the reader joins them back.

`bfloat16` leaves come back as `torch.bfloat16` tensors (numpy has no
bfloat16 without ml_dtypes); every other array comes back as a read-only
numpy array, as flax returns it. Given the same nested dict, `serialize`
gives the bytes `flax.serialization.msgpack_serialize` gives: maps in sorted
key order, as flax writes them (its `tree_map` copy of the tree rebuilds
every dict with sorted keys). Any ext code,
format byte or dtype this module does not know raises `MsgpackFormatError`,
a ValueError: nothing is skipped silently.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NATIVE_COMPLEX = 2
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30          # flax's limit per array leaf, in bytes
CHUNKED_KEY = "__msgpack_chunked_array__"


class MsgpackFormatError(ValueError):
    """Bytes that are not a flax msgpack tree this module can read, or a
    tree it cannot write."""


# -- writing ------------------------------------------------------------------

def _pack_int(n: int, out: List[bytes]) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -0x20 <= n < 0:
        out.append(struct.pack("b", n))
    elif 0x80 <= n <= 0xFF:
        out.append(struct.pack("BB", 0xCC, n))
    elif -0x80 <= n < 0:
        out.append(struct.pack(">Bb", 0xD0, n))
    elif 0xFF < n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, n))
    elif -0x8000 <= n < -0x80:
        out.append(struct.pack(">Bh", 0xD1, n))
    elif 0xFFFF < n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, n))
    elif -0x80000000 <= n < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, n))
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, n))
    elif -0x8000000000000000 <= n < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, n))
    else:
        raise MsgpackFormatError(f"integer {n} does not fit 64 bits")


def _pack_len(n: int, fix_base: int, fix_max: int, codes, out) -> None:
    """A length header: the fix form below `fix_max`, else the 8/16/32-bit
    forms in `codes` (None where the form does not exist)."""
    if fix_base is not None and n <= fix_max:
        out.append(struct.pack("B", fix_base | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack("BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise MsgpackFormatError(f"length {n} exceeds msgpack's 32 bits")


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(struct.pack("Bb", fixed[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    else:
        raise MsgpackFormatError(f"ext payload of {n} bytes exceeds 32 bits")
    out.append(data)


def _array_triple(arr) -> Tuple[tuple, str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or a tensor."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().contiguous()
        if arr.dtype == torch.bfloat16:
            return (tuple(arr.shape), "bfloat16",
                    arr.view(torch.int16).numpy().tobytes())
        arr = arr.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise MsgpackFormatError(
            f"object and structured dtypes cannot be serialized "
            f"({arr.dtype})")
    return tuple(arr.shape), arr.dtype.name, arr.tobytes("C")


def _ndarray_payload(arr) -> bytes:
    """flax's `_ndarray_to_bytes`: packb((shape, dtype, bytes))."""
    shape, name, raw = _array_triple(arr)
    out: List[bytes] = []
    _pack_len(3, 0x90, 0x0F, (None, 0xDC, 0xDD), out)
    _pack_len(len(shape), 0x90, 0x0F, (None, 0xDC, 0xDD), out)
    for dim in shape:
        _pack_int(int(dim), out)
    _pack_str(name, out)
    _pack_len(len(raw), None, -1, (0xC4, 0xC5, 0xC6), out)
    out.append(raw)
    return b"".join(out)


def _pack_str(s: str, out: List[bytes]) -> None:
    data = s.encode("utf-8")
    _pack_len(len(data), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB), out)
    out.append(data)


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _pack_map(items, out: List[bytes]) -> None:
    _pack_len(len(items), 0x80, 0x0F, (None, 0xDE, 0xDF), out)
    for key, value in items:
        _pack_str(key, out)
        _pack(value, out)


def _pack_chunked(arr, out: List[bytes]) -> None:
    """flax's `_chunk`: an oversized array as flat chunks of 2**30 bytes,
    its maps in flax's insertion order (they are built after the sorted
    copy)."""
    itemsize = (arr.element_size() if isinstance(arr, torch.Tensor)
                else arr.dtype.itemsize)
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    shape_items = [(str(i), int(d)) for i, d in enumerate(arr.shape)]
    chunk_items = [(str(i), c) for i, c in enumerate(chunks)]
    _pack_len(3, 0x80, 0x0F, (None, 0xDE, 0xDF), out)
    _pack_str(CHUNKED_KEY, out)
    _pack(True, out)
    _pack_str("shape", out)
    _pack_map(shape_items, out)
    _pack_str("chunks", out)
    _pack_map(chunk_items, out)


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        _pack_str(obj, out)
    elif type(obj) is bytes:
        _pack_len(len(obj), None, -1, (0xC4, 0xC5, 0xC6), out)
        out.append(obj)
    elif type(obj) is dict:
        if not all(type(key) is str for key in obj):
            raise MsgpackFormatError(f"map keys {list(obj)!r} are not all "
                                     f"str")
        _pack_map([(key, obj[key]) for key in sorted(obj)], out)
    elif type(obj) in (list, tuple):
        # flax's to_state_dict stores a sequence as a map of its indices
        _pack({str(i): v for i, v in enumerate(obj)}, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        if _nbytes(obj) > MAX_CHUNK_SIZE:
            _pack_chunked(obj, out)
        else:
            _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif type(obj) is complex:
        inner: List[bytes] = [b"\x92"]
        _pack(obj.real, inner)
        _pack(obj.imag, inner)
        _pack_ext(EXT_NATIVE_COMPLEX, b"".join(inner), out)
    else:
        raise MsgpackFormatError(
            f"cannot serialize {type(obj).__name__}: flax's msgpack trees "
            f"hold dicts with str keys, lists, python scalars and arrays")


def serialize(tree) -> bytes:
    """A tree of dicts (str keys), lists, tuples, python scalars, numpy
    arrays and tensors -> flax msgpack bytes: what
    `msgpack_serialize(to_state_dict(tree))` gives (a list or tuple becomes
    a map of its indices, map keys are sorted)."""
    out: List[bytes] = []
    _pack(tree, out)
    return b"".join(out)


# -- reading ------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackFormatError(
                f"truncated msgpack: {n} bytes wanted at offset {self.pos} "
                f"of {len(self.data)}")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, raw_str: bool = False):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw_str)
        if 0x90 <= b <= 0x9F:
            return [self.value(raw_str) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F, raw_str)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",       # bin
                   0xD9: ">B", 0xDA: ">H", 0xDB: ">I",       # str
                   0xDC: ">H", 0xDD: ">I",                   # array
                   0xDE: ">H", 0xDF: ">I",                   # map
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}       # ext
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in lengths:
            raise MsgpackFormatError(
                f"msgpack format byte 0x{b:02x} at offset {self.pos - 1} is "
                f"not one flax's checkpoints use")
        n = self.unpack(lengths[b])
        if b <= 0xC6:
            return bytes(self.take(n))
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return self.string(n, raw_str)
        if b <= 0xDD:
            return [self.value(raw_str) for _ in range(n)]
        return self.map(n, raw_str)

    def string(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw_str: bool) -> dict:
        out = {}
        for _ in range(n):
            key = self.value(raw_str)
            out[key] = self.value(raw_str)
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == EXT_NPSCALAR:
            arr = _ndarray_from_payload(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) \
                else arr[()]
        if code == EXT_NATIVE_COMPLEX:
            real, imag = _Reader(data).whole()
            return complex(real, imag)
        raise MsgpackFormatError(
            f"msgpack ext type {code} ({n} bytes) is not one of flax's "
            f"(1 ndarray, 2 native_complex, 3 npscalar)")

    def whole(self, raw_str: bool = False):
        value = self.value(raw_str)
        if self.pos != len(self.data):
            raise MsgpackFormatError(
                f"{len(self.data) - self.pos} trailing bytes after the "
                f"msgpack object")
        return value


def _ndarray_from_payload(data: bytes):
    """flax's `_ndarray_from_bytes`: [shape, dtype name, raw bytes]."""
    triple = _Reader(data).whole(raw_str=True)
    if not (isinstance(triple, list) and len(triple) == 3):
        raise MsgpackFormatError("ndarray ext payload is not "
                                 "[shape, dtype, bytes]")
    shape, name, raw = triple
    shape = tuple(int(d) for d in shape)
    name = name.decode() if isinstance(name, bytes) else str(name)
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(raw), dtype=torch.int16)
        return flat.view(torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise MsgpackFormatError(f"unknown array dtype {name!r}") from e
    if dtype.hasobject:
        raise MsgpackFormatError(f"object dtype {name!r} cannot be read")
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def _unchunk(node: dict):
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(node):
    if isinstance(node, dict):
        if CHUNKED_KEY in node:
            return _unchunk(node)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def deserialize(data: bytes):
    """flax msgpack bytes -> the tree `msgpack_restore` returns (numpy
    arrays, `torch.bfloat16` tensors for bfloat16 leaves)."""
    return _unchunk_tree(_Reader(data).whole())
