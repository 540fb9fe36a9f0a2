"""Builds the port's native sources (`csrc/`) at first use into `build/`.

Each library is keyed by a hash of its source and its flags, so an edited
source or flag builds anew and an unchanged one loads what is there. The
build writes to a private temporary name and renames it into place, so
concurrent processes never load a half-written library. A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[1] / "build"


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda): "
                       "the port's CUDA kernels are built from source")


def gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the rANS coder is built "
                           "from source")
    return found


def build(source: Path, compiler: str, flags: Sequence[str],
          stem: str) -> Tuple[Path, float, str]:
    """Build `source` into `build/lib<stem>_<hash>.so` unless it is there.
    Returns (path, build seconds (0.0 when already built), compiler
    output)."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    so = BUILD_DIR / f"lib{stem}_{digest[:16]}.so"
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed "
                           f"({proc.returncode}) on {source}:\n{log}")
    os.replace(tmp, so)
    return so, seconds, log
