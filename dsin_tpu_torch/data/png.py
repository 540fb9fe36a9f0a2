"""PNG files read and written on `zlib` alone (the JAX package reads and
writes them through PIL, which the card machine does not have).

Read: 8-bit, non-interlaced PNGs of colour type gray (0), RGB (2), palette
(3), gray + alpha (4) and RGBA (6), rows under any of the five filters,
converted to (H, W, 3) uint8 RGB as PIL's `im.convert("RGB")` converts them
(gray replicated, alpha dropped, palette entries looked up). Every chunk's
CRC is checked. Anything else (another bit depth, an interlaced image, a
missing or unknown critical chunk, a bad CRC) raises `PngError`, a
ValueError naming what it met.

Write: (H, W, 3) uint8 RGB, 8 bits, every row under the Up filter, zlib
level 6.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOUR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                 6: "RGBA"}
FILTER_UP = 2


class PngError(ValueError):
    """A file this reader does not decode: not a PNG, corrupt, or a form
    it does not support (named in the message)."""


def _chunks(data: bytes, what: str):
    """(type, payload) of every chunk, CRC-checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise PngError(f"{what}: not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise PngError(f"{what}: truncated before IEND")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise PngError(f"{what}: chunk {ctype!r} truncated")
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(ctype + payload) & 0xFFFFFFFF != crc:
            raise PngError(f"{what}: chunk {ctype!r} fails its CRC")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, width: int,
              bpp: int) -> np.ndarray:
    """(height, 1 + width*bpp) filtered scanlines -> (height, width, bpp)
    uint8. Rows under None, Sub and Up go row by row, vectorized; with any
    Average or Paeth row the image is walked by anti-diagonals (a pixel
    needs its left, upper and upper-left neighbours, all on earlier
    diagonals), vectorized along each diagonal."""
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise PngError(f"unknown row filter type {int(ftype.max())}")
    filt = raw[:, 1:].reshape(height, width, bpp)
    if not np.isin(ftype, (3, 4)).any():
        out = np.empty_like(filt)
        prev = np.zeros_like(filt[0])
        for r in range(height):
            row = filt[r]
            if ftype[r] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif ftype[r] == 2:
                row = row + prev
            out[r] = prev = row
        return out
    # rec is padded by a zero row on top and a zero column on the left
    rec = np.zeros((height + 1, width + 1, bpp), np.int32)
    filt32 = filt.astype(np.int32)
    ftype = ftype.astype(np.int32)
    for d in range(height + width - 1):
        r = np.arange(max(0, d - width + 1), min(height, d + 1))
        x = d - r
        a, b, c = rec[r + 1, x], rec[r, x + 1], rec[r, x]
        kind = ftype[r][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[r + 1, x + 1] = (filt32[r, x] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def decode_png(data: bytes, what: str = "PNG") -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB."""
    header = palette = None
    idat = []
    for ctype, payload in _chunks(data, what):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype != b"IEND" and not ctype[0] & 0x20:
            raise PngError(f"{what}: unknown critical chunk {ctype!r}")
    if header is None:
        raise PngError(f"{what}: no IHDR chunk")
    width, height, depth, colour, comp, filt_method, interlace = header
    if colour not in _CHANNELS:
        raise PngError(f"{what}: unknown colour type {colour}")
    if depth != 8:
        raise PngError(f"{what}: bit depth {depth} "
                       f"({_COLOUR_NAMES[colour]}); only 8-bit PNGs are "
                       f"read")
    if interlace:
        raise PngError(f"{what}: interlaced (Adam7) PNGs are not read")
    if comp or filt_method:
        raise PngError(f"{what}: compression method {comp}, filter method "
                       f"{filt_method}; PNG defines only 0")
    bpp = _CHANNELS[colour]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"{what}: IDAT does not inflate ({e})") from e
    if len(raw) != height * (1 + width * bpp):
        raise PngError(f"{what}: {len(raw)} bytes of scanlines, "
                       f"{height * (1 + width * bpp)} expected")
    px = _unfilter(np.frombuffer(raw, np.uint8).reshape(height, -1),
                   height, width, bpp)
    if colour == 3:
        if palette is None:
            raise PngError(f"{what}: palette image without PLTE")
        if px.max(initial=0) >= len(palette):
            raise PngError(f"{what}: palette index {int(px.max())} beyond "
                           f"the {len(palette)} entries")
        return palette[px[..., 0]]
    if colour in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_png(path: str) -> np.ndarray:
    """A PNG file -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes (8-bit RGB, Up filter)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise PngError(f"encode_png takes (H, W, 3) uint8, got "
                       f"{img.dtype} {img.shape}")
    height, width, _ = img.shape
    rows = img.reshape(height, width * 3)
    up = rows.copy()
    up[1:] -= rows[:-1]                        # uint8 arithmetic wraps
    scan = np.concatenate([np.full((height, 1), FILTER_UP, np.uint8), up],
                          axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(scan.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(img, path: str) -> None:
    """Write (H, W, 3) uint8 RGB to `path` as PNG."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
