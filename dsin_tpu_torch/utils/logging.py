"""Training observability (a copy of the JAX package's `utils/logging.py`
host half): wall-clock step timing with images/sec, JSONL scalar logs and
colored console lines. Host-side and O(1) per step."""

from __future__ import annotations

import collections
import json
import os
import sys
import time
from typing import Any, Dict, Optional

_ANSI = {"red": "\033[31m", "green": "\033[32m", "yellow": "\033[33m",
         "blue": "\033[34m", "magenta": "\033[35m", "cyan": "\033[36m"}


def color_print(msg: str, color: str = "cyan", bold: bool = False,
                file=None) -> None:
    """Colored console line; plain when not a TTY (so logs stay clean)."""
    file = file or sys.stdout
    if file.isatty() and color in _ANSI:
        prefix = _ANSI[color] + ("\033[1m" if bold else "")
        print(f"{prefix}{msg}\033[0m", file=file, flush=True)
    else:
        print(msg, file=file, flush=True)


class StepTimer:
    """Rolling wall-clock timing of training steps: `tick()` once per
    completed step; `steps_per_sec` / `images_per_sec(batch)` over the
    window."""

    def __init__(self, window: int = 50):
        self._times = collections.deque(maxlen=window + 1)
        self.total_steps = 0
        self._start = time.perf_counter()

    def tick(self) -> None:
        self._times.append(time.perf_counter())
        self.total_steps += 1

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else 0.0

    def images_per_sec(self, batch_size: int) -> float:
        return self.steps_per_sec * batch_size

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._start


class JsonlLogger:
    """Append-only JSONL scalar log: one {ts, step, **scalars} object per
    line, line-buffered."""

    def __init__(self, path: Optional[str]):
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def log(self, step: int, scalars: Dict[str, Any], **extra: Any) -> None:
        if self._f is None:
            return
        rec = {"ts": round(time.time(), 3), "step": int(step)}
        for k, v in {**scalars, **extra}.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
