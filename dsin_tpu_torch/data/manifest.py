"""Dataset manifests: text files listing correlated image pairs (a copy of
the JAX package's `data/manifest.py`).

Contract of the reference's manifest format (reference DataProvider.py:96-126):
a manifest lists relative paths, one per line, with the primary image `x` on
even lines and its side-information image `y` on the following odd line.
Paths are joined with `root` (no separator added — the reference concatenates
strings directly, so `root` usually ends with '/'; we are more forgiving and
insert one when missing).
"""

from __future__ import annotations

import os
from typing import List, Tuple


def read_pair_manifest(path: str, root: str = "") -> List[Tuple[str, str]]:
    """Read x/y alternating-line manifest into a list of (x_path, y_path)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if len(lines) % 2 != 0:
        raise ValueError(
            f"manifest {path} has {len(lines)} non-empty lines; expected an "
            f"even count of alternating x/y entries")
    if root and not root.endswith(os.sep):
        root = root + os.sep
    xs = [root + p for p in lines[0::2]]
    ys = [root + p for p in lines[1::2]]
    return list(zip(xs, ys))


def num_pairs(path: str) -> int:
    """Number of (x, y) pairs listed in the manifest (reference AE.py:29)."""
    with open(path) as f:
        n = sum(1 for ln in f if ln.strip())
    if n % 2 != 0:
        raise ValueError(
            f"manifest {path} has {n} non-empty lines; expected an even count "
            f"of alternating x/y entries")
    return n // 2
