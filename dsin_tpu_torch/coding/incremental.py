"""Pure-numpy incremental wavefront engine for the bottleneck codec (a copy of
the JAX package's `coding/incremental.py`, codec mode 2).

A per-symbol engine recomputes the full (context_D, cs, cs) cone of the
`res_shallow` network for every symbol (~2.1 MFLOPs a symbol). This engine
instead keeps a cached activation buffer for every layer of the network
(conv0(first mask) -> relu -> [conv->relu->conv + cropped skip] -> conv ->
relu) and updates each activation voxel exactly ONCE, the moment its causal
inputs are complete: one fully-convolutional forward in total, run in
wavefront order as small gather+matmul batches, with no device in the loop.

Scheduling: with the wavefront time t(d, h, w) = a*d + b*h + w (the same
coefficients as `codec._wavefronts`: any causal dependency is strictly
earlier), each layer voxel p gets an availability time tau(p) = max over its
unmasked filter taps of the input's availability (tau of the padded q buffer
= t of the position, -1 for padding). A voxel is computed right after front
tau(p) is written; the logits of front T provably need only voxels with
tau < T, which the schedule builder asserts for every shape it builds.

Determinism: encode and decode run this identical numpy code over identical
buffer states on the same float32 weight matrices, so the PMFs and the
quantized tables agree bit for bit; the JAX package's engine is the same
code, so mode-2 streams are byte-identical across the two packages.

Thread safety: the weights are read-only after __init__, every `begin()`
returns a `_VolumePass` that owns its mutable buffers, and the per-shape
schedule cache is guarded by a lock.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from dsin_tpu_torch.models import probclass as pc_lib


def wavefront_coeffs(pad: int) -> Tuple[int, int]:
    """(a, b) of t = a*d + b*h + w; see codec._wavefronts for the proof."""
    b = pad + 1
    return pad * (b + 1) + 1, b


def _masked_window_max(t: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """VALID sliding max of `t` over `mask`'s nonzero taps (floor -1)."""
    win = np.lib.stride_tricks.sliding_window_view(t, mask.shape)
    sel = np.where(mask > 0, win, np.int64(-1))
    return sel.max(axis=(3, 4, 5))


def _flat(pos: np.ndarray, dims: Tuple[int, int, int]) -> np.ndarray:
    """(n, 3) int positions -> flat row indices for a (dims + (C,)) buffer."""
    return (pos[:, 0] * dims[1] + pos[:, 1]) * dims[2] + pos[:, 2]


def _tap_offsets(in_dims: Tuple[int, int, int],
                 fshape: Tuple[int, int, int]) -> np.ndarray:
    """Flat offsets of the filter taps inside the input buffer."""
    td, th, tw = np.meshgrid(np.arange(fshape[0]), np.arange(fshape[1]),
                             np.arange(fshape[2]), indexing="ij")
    return ((td * in_dims[1] + th) * in_dims[2] + tw).reshape(-1)


def _group_by_tau(tau: np.ndarray, self_dims, in_dims) -> Dict[int, tuple]:
    """tau volume -> {tau: (self_flat_rows, input_window_base_rows)}."""
    pos = np.argwhere(tau >= -1)          # all positions, (n, 3)
    taus = tau.reshape(-1)
    order = np.argsort(taus, kind="stable")
    pos, taus = pos[order], taus[order]
    self_flat = _flat(pos, self_dims)
    in_base = _flat(pos, in_dims)         # window starts at the same coords
    groups: Dict[int, tuple] = {}
    bounds = np.flatnonzero(np.diff(taus)) + 1
    for sf, ib, tv in zip(np.split(self_flat, bounds),
                          np.split(in_base, bounds),
                          taus[np.r_[0, bounds]]):
        groups[int(tv)] = (sf, ib)
    return groups


class _Schedule:
    """Everything shape-dependent, precomputed once per volume shape."""

    def __init__(self, shape: Tuple[int, int, int], kernel_size: int,
                 masks: List[np.ndarray]):
        d, h, w = shape
        k = kernel_size
        fd = k // 2 + 1
        pad = pc_lib.context_size(k) // 2
        a, b = wavefront_coeffs(pad)
        self.pad = pad

        def shrink(dims):
            return (dims[0] - (fd - 1), dims[1] - (k - 1), dims[2] - (k - 1))

        self.a0_dims = (d + pad, h + 2 * pad, w + 2 * pad)
        self.act1_dims = shrink(self.a0_dims)
        self.r1_dims = shrink(self.act1_dims)
        self.act3_dims = shrink(self.r1_dims)
        out_dims = shrink(self.act3_dims)
        assert out_dims == shape, (out_dims, shape)
        self.skip_off = (2 * (k // 2), k - 1, k - 1)

        # availability times
        t_q = np.full(self.a0_dims, -1, dtype=np.int64)
        dd, hh, ww = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                                 indexing="ij")
        t_q[pad:, pad:pad + h, pad:pad + w] = a * dd + b * hh + ww
        tau1 = _masked_window_max(t_q, masks[0])
        tau_r1 = _masked_window_max(tau1, masks[1])
        so = self.skip_off
        tau3 = np.maximum(
            _masked_window_max(tau_r1, masks[2]),
            tau1[so[0]:, so[1]:-so[1] or None, so[2]:-so[2] or None])
        tau_log = _masked_window_max(tau3, masks[3])
        t_out = a * dd + b * hh + ww
        # the causal guarantee the whole stream rests on: every input any
        # front's logits touch is strictly earlier than the front itself
        assert (tau_log < t_out).all(), "causality violated in schedule"

        self.groups1 = _group_by_tau(tau1, self.act1_dims, self.a0_dims)
        self.groups_r1 = _group_by_tau(tau_r1, self.r1_dims, self.act1_dims)
        self.groups3 = _group_by_tau(tau3, self.act3_dims, self.r1_dims)

        # q fronts (identical grouping to codec._wavefronts: stable sort of
        # t keeps raster order within a front)
        posq = np.stack([dd, hh, ww], axis=-1).reshape(-1, 3)
        tq = t_out.reshape(-1)
        order = np.argsort(tq, kind="stable")
        posq, tq = posq[order], tq[order]
        bnds = np.flatnonzero(np.diff(tq)) + 1
        self.fronts = list(zip(
            [int(v) for v in tq[np.r_[0, bnds]]],
            np.split(posq, bnds)))
        self.front_a0_rows = [
            _flat(f + pad, self.a0_dims) for _, f in self.fronts]
        self.front_act3_base = [_flat(f, self.act3_dims)
                                for _, f in self.fronts]
        # skip-gather rows in act1 for act3 updates
        self.skip_rows = {}
        for tv, (sf, _) in self.groups3.items():
            p3 = np.stack(np.unravel_index(sf, self.act3_dims), axis=-1)
            self.skip_rows[tv] = _flat(p3 + np.asarray(so), self.act1_dims)

        self.offs0 = _tap_offsets(self.a0_dims, masks[0].shape)
        self.offs1 = _tap_offsets(self.act1_dims, masks[1].shape)
        self.offs2 = _tap_offsets(self.r1_dims, masks[2].shape)
        self.offs3 = _tap_offsets(self.act3_dims, masks[3].shape)


class IncrementalResShallow:
    """Numpy twin of models/probclass.ResShallow for sequential coding.

    `weights` are the four pre-masked (W, b) pairs of
    `probclass.front_weight_matrices`; the four layers run as gather+matmul
    over flat (rows, channels) buffers.
    """

    def __init__(self, weights: Sequence[Tuple[np.ndarray, np.ndarray]],
                 centers: np.ndarray, kernel_size: int, pad_value: float):
        self.k = int(kernel_size)
        self.masks = [pc_lib.make_mask(self.k, include_center=bool(i))
                      for i in (0, 1, 1, 1)]
        assert len(weights) == 4, len(weights)
        self.W = [np.asarray(w, dtype=np.float32) for w, _ in weights]
        self.b = [np.asarray(b, dtype=np.float32) for _, b in weights]
        self.centers = np.asarray(centers, dtype=np.float32)
        self.pad_value = np.float32(pad_value)
        self._schedules: Dict[Tuple[int, int, int], _Schedule] = {}
        self._sched_lock = threading.Lock()

    def schedule(self, shape: Tuple[int, int, int]) -> _Schedule:
        shape = tuple(int(s) for s in shape)
        with self._sched_lock:
            sch = self._schedules.get(shape)
        if sch is None:
            # built outside the lock; racing builders converge through
            # setdefault (a schedule is a pure function of the shape)
            sch = _Schedule(shape, self.k, self.masks)
            with self._sched_lock:
                sch = self._schedules.setdefault(shape, sch)
        return sch

    def begin(self, shape) -> "_VolumePass":
        return _VolumePass(self, self.schedule(shape))


def _gather_matmul(buf2d: np.ndarray, bases: np.ndarray, offs: np.ndarray,
                   W: np.ndarray, b: np.ndarray) -> np.ndarray:
    """rows = relu-less conv at `bases`: (n, taps*C_in) @ W + b."""
    x = buf2d[bases[:, None] + offs[None, :]]        # (n, taps, C_in)
    return x.reshape(len(bases), -1) @ W + b


class _VolumePass:
    """One encode/decode traversal: buffers + per-front update machinery."""

    def __init__(self, eng: IncrementalResShallow, sch: _Schedule):
        self.eng, self.sch = eng, sch
        self.a0 = np.full((np.prod(sch.a0_dims), 1), eng.pad_value,
                          dtype=np.float32)
        self.act1 = np.zeros((np.prod(sch.act1_dims), eng.W[0].shape[1]),
                             np.float32)
        self.r1 = np.zeros((np.prod(sch.r1_dims), eng.W[1].shape[1]),
                           np.float32)
        self.act3 = np.zeros((np.prod(sch.act3_dims), eng.W[2].shape[1]),
                             np.float32)
        self._update(-1)  # pure-padding voxels are available up front

    def _update(self, tv: int) -> None:
        """Compute every layer voxel that became available at front `tv`."""
        eng, sch = self.eng, self.sch
        g = sch.groups1.get(tv)
        if g is not None:
            sf, ib = g
            self.act1[sf] = np.maximum(_gather_matmul(
                self.a0, ib, sch.offs0, eng.W[0], eng.b[0]), 0.0)
        g = sch.groups_r1.get(tv)
        if g is not None:
            sf, ib = g
            self.r1[sf] = np.maximum(_gather_matmul(
                self.act1, ib, sch.offs1, eng.W[1], eng.b[1]), 0.0)
        g = sch.groups3.get(tv)
        if g is not None:
            sf, ib = g
            self.act3[sf] = (_gather_matmul(self.r1, ib, sch.offs2,
                                            eng.W[2], eng.b[2])
                             + self.act1[sch.skip_rows[tv]])

    def logits_for(self, front_idx: int) -> np.ndarray:
        """(n, L) float32 logits for front `front_idx` (final relu incl.)."""
        sch, eng = self.sch, self.eng
        return np.maximum(_gather_matmul(
            self.act3, sch.front_act3_base[front_idx], sch.offs3,
            eng.W[3], eng.b[3]), 0.0)

    def write(self, front_idx: int, symbols: np.ndarray) -> None:
        """Write front symbols' centers into the q buffer, then run the
        layer updates unlocked by this front."""
        tv = self.sch.fronts[front_idx][0]
        rows = self.sch.front_a0_rows[front_idx]
        self.a0[rows, 0] = self.eng.centers[symbols]
        self._update(tv)
