"""The model a batch reads, as one value (the part of the JAX package's
`serve/swap.py` that the dataplane reads: `ModelBundle` and the `current`
slot of `SwapCoordinator`).

"The model" is several coupled things the dataplane reads at different
moments: the device weights of the batched device functions, the codec's
context-model weights on the host, the per-thread codec clones of the
entropy pool, and with the process entropy backend the pool of children
that hold their own codec. A `ModelBundle` holds them all; a worker captures ONE bundle
at batch start and threads it through every stage of that batch, so the
device stage and the entropy stage always read the same model.

The hot swap itself (staging, commit, rollback, the previous bundle kept
warm) is not ported: `SwapCoordinator` holds `current` only. It still
publishes the `serve_swap_state` gauge (0, idle) and the
`serve_model_digest` info entry every scrape carries.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

#: serve_swap_state gauge value (the only state without the hot swap)
SWAP_IDLE = 0


class ModelBundle:
    """One model version, whole: the `DeviceServer` (weights on the
    device), the host codec, the digest that names them (the JAX package's
    `params_digest`) and the checkpoint they came from. Immutable except
    the process entropy backend's pool slot, which a child-death rebuild
    swaps under the slot's lock; `proc_initargs` (the pool initializer's
    arguments: the path of the pickled `CodecSpec` and the warm shapes) is
    None on the thread backend."""

    __slots__ = ("epoch", "digest", "ckpt", "server", "codec",
                 "proc_initargs", "_proc", "_proc_lock")

    def __init__(self, epoch: int, digest: str, server, codec, *,
                 ckpt: Optional[str] = None, proc_initargs=None):
        self.epoch = int(epoch)
        self.digest = digest
        self.ckpt = ckpt
        self.server = server
        self.codec = codec
        self.proc_initargs = proc_initargs
        self._proc_lock = threading.Lock()
        self._proc = None              # guarded-by: self._proc_lock

    # -- process-backend pool slot -------------------------------------------

    def proc(self):
        with self._proc_lock:
            return self._proc

    def set_proc(self, pool) -> None:
        with self._proc_lock:
            self._proc = pool

    def swap_proc_if(self, seen, factory) -> bool:
        """Child-death rebuild: the first bridge thread to report `seen`
        swaps in `factory()`; later reporters find it already replaced.
        The factory runs under the slot lock: it only constructs an
        executor (children spawn lazily at the first submit)."""
        with self._proc_lock:
            if self._proc is not seen:
                return False
            self._proc = factory()
        return True

    def retire(self, wait: bool = False) -> None:
        """Shut down this bundle's process pool, if any, outside the slot
        lock. Idempotent. Tasks already submitted run to completion
        (shutdown only refuses new work); `wait` joins the children."""
        with self._proc_lock:
            pool, self._proc = self._proc, None
        if pool is not None:
            pool.shutdown(wait=wait)

    def __repr__(self) -> str:
        return (f"ModelBundle(epoch={self.epoch}, digest={self.digest!r}, "
                f"ckpt={self.ckpt!r})")


class SwapCoordinator:
    """The `current` bundle slot under a lock, read once per batch."""

    def __init__(self, current: ModelBundle, metrics):
        self._lock = threading.Lock()
        self._current = current            # guarded-by: self._lock
        self.metrics = metrics
        snap = self.snapshot()
        self.metrics.gauge("serve_swap_state").set(snap["swap_state"])
        self.metrics.set_info("serve_model_digest", snap)

    @property
    def current(self) -> ModelBundle:
        with self._lock:
            return self._current

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            cur = self._current
        return {"digest": cur.digest, "epoch": cur.epoch, "ckpt": cur.ckpt,
                "prev_digest": None, "staged_digest": None,
                "swap_state": SWAP_IDLE}
