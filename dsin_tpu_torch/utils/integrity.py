"""CRC32 framing checks and the typed error they raise (a copy of the JAX
package's `utils/integrity.py:20-45`).

A flipped bit in an rANS payload desynchronizes the decoder's PMFs from the
encoder's and decodes to a plausible wrong image, so integrity lives in the
framing: DSIM v3 (`coding/cli.py`) carries a CRC32 over its header fields and
payload, verified before any entropy decode. `IntegrityError` subclasses
ValueError, so every "bad stream" handler routes it too.
"""

from __future__ import annotations

import zlib


class IntegrityError(ValueError):
    """A stream failed its CRC: corrupted in transit or on disk. The
    payload must not be entropy-decoded (it would yield a plausible but
    wrong reconstruction, silently)."""


def frame_crc(*chunks: bytes) -> int:
    """CRC32 over the concatenation of `chunks` (header fields then
    payload; the CRC field itself is never included)."""
    crc = 0
    for chunk in chunks:
        crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def verify_crc(expected: int, what: str, *chunks: bytes) -> None:
    """Raise IntegrityError unless `frame_crc(*chunks) == expected`."""
    got = frame_crc(*chunks)
    if got != expected:
        raise IntegrityError(
            f"{what}: CRC mismatch (stored 0x{expected:08x}, computed "
            f"0x{got:08x}) — the stream is corrupted; refusing to decode "
            f"it into a plausible wrong image")
