"""Static shape buckets: arbitrary request shapes -> a fixed executable set.

XLA specializes every executable to exact shapes, so a service that jits
per request shape compiles without bound — the classic learned-codec
serving failure ("Evaluating the Practicality of Learned Image
Compression", PAPERS.md). The fix is the standard one: declare a SMALL
static set of padded bucket geometries up front, route every request to
the smallest bucket that fits, and pad. Steady-state executable count is
then `2 * len(buckets)` (one batched encode + one batched decode each),
which warm-up compiles once and `CompilationSentinel(budget=0)` pins
forever after (see tests/test_serve_service.py).

Padding uses edge replication, not zeros: the AE is convolutional, so a
hard black border would bleed ringing into the real pixels' receptive
fields AND cost rate (the context model would spend bits on the edge).
Replicated edges compress almost for free and are cropped away after
decode — the client only ever sees its original (h, w).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

#: every bucket edge must divide by the AE's total subsampling factor so
#: the bottleneck grid is whole (coding/cli.py enforces the same for its
#: un-bucketed one-shot path)
SUBSAMPLING = 8

#: default geometry ladder: KITTI-ish wide shapes plus a square fallback,
#: all /8. Services with a known shape distribution pass their own.
DEFAULT_BUCKETS = ((128, 256), (256, 512), (384, 1280))


class NoBucketFits(ValueError):
    """Request larger than every configured bucket — a routing error the
    client must see immediately, not an OOM later."""


class BucketPolicy:
    """Maps (h, w) -> the smallest configured bucket that fits.

    "Smallest" means fewest padded pixels: buckets are tried in area
    order, ties broken by height, so a request never pays for a bigger
    executable than it needs.
    """

    def __init__(self, buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS):
        if not buckets:
            raise ValueError("need at least one bucket shape")
        seen = set()
        for bh, bw in buckets:
            if bh <= 0 or bw <= 0 or bh % SUBSAMPLING or bw % SUBSAMPLING:
                raise ValueError(
                    f"bucket {(bh, bw)} must be positive and divisible by "
                    f"the subsampling factor {SUBSAMPLING}")
            if (bh, bw) in seen:
                raise ValueError(f"duplicate bucket {(bh, bw)}")
            seen.add((bh, bw))
        self.buckets = tuple(sorted((tuple(b) for b in buckets),
                                    key=lambda b: (b[0] * b[1], b[0])))

    def bucket_for(self, h: int, w: int) -> Tuple[int, int]:
        if h <= 0 or w <= 0:
            # jaxlint: disable=contract-typed-raise -- synchronous arg
            # validation at the submission boundary (no future exists
            # yet); ValueError on malformed input is the documented
            # misuse contract
            raise ValueError(f"bad image shape ({h}, {w})")
        for bh, bw in self.buckets:
            if h <= bh and w <= bw:
                return (bh, bw)
        raise NoBucketFits(
            f"image ({h}, {w}) exceeds every bucket "
            f"{list(self.buckets)} — add a larger bucket to the service "
            f"config or downscale the request")

    def __repr__(self) -> str:
        return f"BucketPolicy({list(self.buckets)})"


def pad_to_bucket(img: np.ndarray, bucket: Tuple[int, int]) -> np.ndarray:
    """(h, w, 3) -> (bh, bw, 3) by edge replication (bottom/right).

    Always returns fresh storage, even on an exact fit: callers enqueue
    the result (serve/batcher.py), and an alias of the input would let a
    caller reusing its frame buffer corrupt work that is still queued."""
    h, w = img.shape[:2]
    bh, bw = bucket
    if h > bh or w > bw:
        # jaxlint: disable=contract-typed-raise -- unreachable on the
        # request path by construction: submit_encode picked this bucket
        # via bucket_for, which only returns covering buckets; defensive
        # invariant guard for direct callers
        raise ValueError(f"image ({h}, {w}) does not fit bucket {bucket}")
    if (h, w) == (bh, bw):
        return img.copy()
    return np.pad(img, ((0, bh - h), (0, bw - w), (0, 0)), mode="edge")


def crop_from_bucket(img: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Inverse of pad_to_bucket: top-left (h, w) crop of the decoded
    bucket-sized reconstruction."""
    h, w = shape
    return img[:h, :w]
