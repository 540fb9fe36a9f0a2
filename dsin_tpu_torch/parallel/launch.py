"""Spawn the ranks of one host and collect what each returns.

    results = run_ranks(fn, 4, args, backend="gloo", device="cuda:0",
                        init_file=path)
    ranks = start_ranks(...)       # returns once every rank is spawned
    results = ranks.results(timeout_s)

Each rank is a process of its own (the `spawn` start method), given
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE),
which joins a `file://` rendezvous at `init_file` (no port, so concurrent
groups on one host cannot collide) through `mesh.init_distributed`, runs
`fn(device, *args)` and sends back its return value, pickled. `fn` must be
importable by module path. `args` travel pickled in a file beside the
rendezvous file, not through each child's start pipe, where a large
argument would block the start of the next rank until this one had
started its interpreter. A rank that raises sends its traceback; the
first failure, or the timeout, stops every rank (killed) and raises
`RankFailed`; a rank that raises also prints its traceback at once. The
ranks are daemonic: they end with the process that spawned them. What the ranks build natively, the caller builds first:
`native_build` loads a library a process before them wrote.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import sys
import time
import traceback
from typing import Callable, Optional, Sequence

DEFAULT_TIMEOUT_S = 300.0


class RankFailed(RuntimeError):
    """A rank raised, died or outlived the timeout."""


def _rank_main(rank: int, world: int, fn: Callable, args_file: str,
               backend: str, device: str, init_method: str,
               timeout_s: float, threads: Optional[int], out) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import torch
    import torch.distributed as dist

    from dsin_tpu_torch.parallel.mesh import init_distributed
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        with open(args_file, "rb") as f:
            args = pickle.load(f)
        dev = init_distributed(backend, device, init_method, timeout_s)
        out.put((rank, True, fn(dev, *args)))
    except BaseException:  # noqa: BLE001 — reported, then the rank ends
        text = traceback.format_exc()
        print(f"rank {rank} of {world}:\n{text}", file=sys.stderr, flush=True)
        out.put((rank, False, text))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """The ranks `start_ranks` spawned; `results` collects them."""

    def __init__(self, procs: list, out, args_file: str):
        self._procs, self._out, self._args_file = procs, out, args_file

    def results(self, timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
        """The ranks' returns in rank order, once every rank has sent its
        own; the first failure, or `timeout_s`, ends every rank and raises
        RankFailed."""
        procs, out, world = self._procs, self._out, len(self._procs)
        results, failure = {}, None
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < world and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = (f"{world - len(results)} rank(s) still "
                               f"running after {timeout_s:g} s")
                    break
                try:
                    rank, ok, payload = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.name for r, p in enumerate(procs)
                            if r not in results and p.exitcode is not None]
                    if dead:
                        # a last message may still be in flight
                        time.sleep(1.0)
                        if out.empty():
                            failure = f"{dead} ended without a result"
                    continue
                if ok:
                    results[rank] = payload
                else:
                    failure = f"rank {rank} raised:\n{payload}"
        finally:
            for p in procs:
                p.join(timeout=10.0 if failure is None else 0.5)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            out.close()
            os.unlink(self._args_file)
        if failure is not None:
            raise RankFailed(failure)
        return [results[r] for r in range(world)]


def start_ranks(fn: Callable, world: int, args: Sequence = (),
                backend: str = "gloo", device: str = "cpu",
                init_file: Optional[str] = None,
                timeout_s: float = DEFAULT_TIMEOUT_S,
                threads: Optional[int] = None) -> Ranks:
    """Spawn `world` ranks of `fn(device, *args)` and return at once, every
    rank a child of this process; `timeout_s` bounds each collective.
    `threads` sets each rank's torch intra-op threads."""
    if init_file is None or os.path.exists(init_file):
        raise ValueError(f"init_file {init_file!r}: a path that does not "
                         f"exist yet (the rendezvous file)")
    args_file = f"{init_file}.args"
    with open(args_file, "wb") as f:
        pickle.dump(tuple(args), f)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, name=f"rank-{r}", daemon=True,
        args=(r, world, fn, args_file, backend, device,
              f"file://{os.path.abspath(init_file)}", timeout_s, threads,
              out)) for r in range(world)]
    for p in procs:
        p.start()
    return Ranks(procs, out, args_file)


def run_ranks(fn: Callable, world: int, args: Sequence = (),
              backend: str = "gloo", device: str = "cpu",
              init_file: Optional[str] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S,
              threads: Optional[int] = None) -> list:
    """`start_ranks`, then their returns in rank order within
    `timeout_s`."""
    return start_ranks(fn, world, args, backend, device, init_file,
                       timeout_s, threads).results(timeout_s)
