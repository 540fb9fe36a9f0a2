"""A windowed `torch.profiler` trace of the training loop (counterpart of the
JAX package's `utils/profiling.py`).

`StepProfiler` starts `torch.profiler.profile` (CPU activity, and CUDA
activity on a card; `record_shapes=True`, no stacks: a full-width trace
with stacks is large) at a chosen step and stops it N steps later, writing
one Chrome trace (`.json`, viewable in Perfetto or `chrome://tracing`)
under `trace_dir`. `annotation(i)` marks step i's span as
`train_step#<i>`, torch's own `ProfilerStep#<i>` convention, so per-step
timelines line up in the viewer. On a card, `stop()` synchronizes the
device before it closes the trace, so the last traced step's kernels land
in it, and a trace without device events is an error (CUPTI missing), not
a quiet empty trace.

`trace_summary(path)` reads such a trace back: the annotations, and the
device kernels by name with their time, launches and the operator (with
its input shapes) that launched them.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
from typing import Optional

import torch

ANNOTATION = "train_step"
#: trace event categories that run on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class StepProfiler:
    """Trace steps [start_step, start_step + num_steps) into `trace_dir`.

    Call `step(i)` once per loop iteration (before running the step).
    No-ops entirely when trace_dir is None. `device` is the training
    device: on a card the trace records CUDA activity too."""

    def __init__(self, trace_dir: Optional[str], start_step: int = 5,
                 num_steps: int = 3, device=None):
        self.trace_dir = trace_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.trace_path: Optional[str] = None
        self._prof = None

    def step(self, i: int) -> None:
        if self.trace_dir is None:
            return
        if self._prof is None and i == self.start_step:
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(self.trace_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities, record_shapes=True,
                                 with_stack=False)
            self._prof.start()
        elif self._prof is not None and i >= self.stop_step:
            self.stop()

    @property
    def active(self) -> bool:
        """True while a trace window is open (callers that pipeline device
        work must drain it before the window closes)."""
        return self._prof is not None

    def stop(self) -> None:
        """Close the window: synchronize the card, stop the profiler and
        write the trace. Raises RuntimeError when a CUDA trace holds no
        device event."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        if self.cuda:
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(
            self.trace_dir,
            f"trace_steps{self.start_step}-{self.stop_step - 1}.json")
        prof.export_chrome_trace(path)
        self.trace_path = path
        if self.cuda and not trace_summary(path)["device_events"]:
            raise RuntimeError(
                f"the profiler trace {path} holds no device event: CUDA "
                f"activity was not recorded (is CUPTI available?)")

    def annotation(self, i: int):
        """Step-scoped trace annotation (no-op context when disabled)."""
        if self.trace_dir is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"{ANNOTATION}#{i}")


def trace_summary(path: str) -> dict:
    """A Chrome trace written by `StepProfiler`: {"annotations": the
    `train_step#<i>` steps in order, "device_events": count,
    "kernels": {name: {"count", "us", "attributed", "launches_in_steps",
    "ops"}}}, where `attributed` counts the kernel's launches whose
    host-side launch call the trace records, `launches_in_steps` those of
    them that lie inside a step annotation, and `ops` maps the
    launching operator (name and input shapes, the innermost operator
    around the launch) to its device microseconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps, ops, launches, kernels = [], [], {}, []
    for e in events:
        cat, name = e.get("cat"), str(e.get("name", ""))
        if e.get("ph") != "X":
            continue
        if cat == "user_annotation" and name.startswith(ANNOTATION + "#"):
            steps.append((e["ts"], e["ts"] + e.get("dur", 0),
                          int(name.split("#", 1)[1])))
        elif cat == "cpu_op":
            ops.append((e["ts"], e["ts"] + e.get("dur", 0), e.get("tid"),
                        name, e.get("args", {}).get("Input Dims")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["ts"], e.get("tid"))
        elif cat in DEVICE_CATEGORIES:
            kernels.append(e)
    steps.sort()
    by_tid = collections.defaultdict(list)
    for op in sorted(ops, key=lambda op: op[0]):
        by_tid[op[2]].append(op)
    starts = {tid: [op[0] for op in rows] for tid, rows in by_tid.items()}

    def innermost_op(ts, tid):
        """The operator that started last before `ts` on `tid` and is
        still open at `ts` (ops nest, so that is the innermost)."""
        rows = by_tid.get(tid, ())
        for j in range(bisect.bisect_right(starts.get(tid, ()), ts) - 1,
                       -1, -1):
            start, end, _, name, dims = rows[j]
            if end >= ts:
                return f"{name} {dims}"
        return "?"

    table = collections.OrderedDict()
    for k in kernels:
        if k.get("cat") != "kernel":
            continue
        row = table.setdefault(k["name"], {"count": 0, "us": 0.0,
                                           "attributed": 0,
                                           "launches_in_steps": 0,
                                           "ops": collections.Counter()})
        row["count"] += 1
        row["us"] += float(k.get("dur", 0))
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is None:
            continue
        row["attributed"] += 1
        ts, tid = launch
        if any(a <= ts <= b for a, b, _ in steps):
            row["launches_in_steps"] += 1
        row["ops"][innermost_op(ts, tid)] += float(k.get("dur", 0))
    return {"annotations": [s for _, _, s in steps],
            "device_events": len(kernels), "kernels": dict(table)}
