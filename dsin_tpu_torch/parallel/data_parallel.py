"""The train and eval steps over a (data, spatial) mesh (counterpart of the
JAX package's `parallel/data_parallel.py`).

The JAX package jits ONE global-batch program and lets GSPMD insert the
collectives. Here each rank runs `train/step.py`'s step on its own rows,
and the program's meaning is kept by hand wherever a nonlinearity sees the
whole batch: every batch mean and sum of the step (the train-mode batch
norms' statistics, the rate hinge's H_soft, the distortions and PSNR, the
SI L1 term, bpp; MS-SSIM's level means) goes through `BatchAxis`, a local
sum all-reduced over the data axis whose backward is the same all-reduce.
Every rank then computes the global loss, and its backward gives the
gradient of (data ranks) x that loss, so the gradients are averaged over
the data axis before the update: the global-batch gradient, not the
average of per-rank losses' gradients. `loss / batch_size` divides by the
config's (global) batch size. The running statistics are folded from the
global statistics, so every rank keeps the same state. `grad_accum`: the
JAX package's micro k is rows k::grad_accum of the global batch, whose
rows the data axis holds in blocks; with blocks a multiple of grad_accum
(refused otherwise) those are this rank's rows k::grad_accum.

The width-sharded step (`make_spatial_train_step`): PyTorch has no GSPMD,
so the convolutions are not sharded. Each spatial rank of a data row holds
the row's whole x and y and runs the conv stacks whole; only the patch
search is sharded, over its width shard of the decoded side image
(`parallel/spatial.py`). The ranks of a spatial column compute the same
gradients, and the reduction runs over the data axis only. The search is
the part that does not fit (74% of the Cityscapes step on one H100); the
convs of a 1024x2048 step fit one card.
"""

from __future__ import annotations

import math
import time
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS, Mesh
from dsin_tpu_torch.parallel import spatial as spatial_lib
from dsin_tpu_torch.train import step as step_lib


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group's ranks; its backward is the same sum (the adjoint
    of a sum replicated to every rank)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchAxis:
    """The data axis of a mesh as the batch axis of one global batch whose
    rows its ranks hold in equal blocks: global sums and means (each a
    local sum, all-reduced), and the gradient average. `last` holds the
    last gradient all-reduce's host ms (between synchronizations on a
    card) and bytes."""

    def __init__(self, mesh: Mesh):
        self.group = mesh.groups[DATA_AXIS]
        self.size = mesh.shape[DATA_AXIS]
        self.last = {"allreduce_ms": 0.0, "allreduce_bytes": 0}

    def sum(self, t: torch.Tensor, dims: Optional[Sequence[int]] = None):
        local = t.sum() if dims is None else t.sum(dim=tuple(dims))
        return _AllReduceSum.apply(local, self.group)

    def _inv_count(self, t: torch.Tensor, dims) -> torch.Tensor:
        count = (t.numel() if dims is None
                 else math.prod(t.shape[d] for d in dims)) * self.size
        return (torch.tensor(1.0, dtype=torch.float32) / count).to(t.device)

    def mean(self, t: torch.Tensor, dims: Optional[Sequence[int]] = None):
        return self.sum(t, dims) * self._inv_count(t, dims)

    def means(self, tensors: Sequence[torch.Tensor],
              dims: Optional[Sequence[int]] = None) -> tuple:
        """The global means of tensors of one shape, in one all-reduce."""
        local = torch.stack([t.sum() if dims is None else t.sum(
            dim=tuple(dims)) for t in tensors])
        total = _AllReduceSum.apply(local, self.group)
        inv = self._inv_count(tensors[0], dims)
        return tuple(total[i] * inv for i in range(len(tensors)))

    def average_grads(self, params: Iterable[torch.Tensor]) -> None:
        """Replace each gradient by its mean over the data axis: one
        all-reduce of the flattened gradients."""
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        on_card = flat.is_cuda
        if on_card:
            torch.cuda.synchronize(flat.device)
        t0 = time.perf_counter()
        dist.all_reduce(flat, group=self.group)
        if on_card:
            torch.cuda.synchronize(flat.device)
        self.last = {"allreduce_ms": 1e3 * (time.perf_counter() - t0),
                     "allreduce_bytes": flat.numel() * flat.element_size()}
        flat.mul_(1.0 / self.size)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def batch_axis(mesh: Mesh) -> Optional[BatchAxis]:
    """The mesh's BatchAxis, or None when the data axis is one rank (then
    the step is the one-rank step's own arithmetic)."""
    return BatchAxis(mesh) if mesh.shape[DATA_AXIS] > 1 else None


def _check_accum(model, mesh: Mesh, grad_accum: int) -> None:
    batch = int(model.ae_config.batch_size)
    rows, left = divmod(batch, mesh.shape[DATA_AXIS])
    if left or rows % grad_accum:
        raise ValueError(
            f"batch_size {batch} over {mesh.shape[DATA_AXIS]} data ranks with "
            f"grad_accum {grad_accum}: each rank's rows must be a multiple "
            f"of grad_accum, so that micro k (rows k::grad_accum of the "
            f"global batch) is rows k::grad_accum of every rank's block")


def make_sharded_train_step(model, optimizer, mesh: Mesh, si_mask=None,
                            grad_accum: int = 1, on_search=None):
    """(x, y) -> (TrainState, metrics) on this rank's rows of the global
    batch (`mesh.shard_batch`): the global-batch step over the data axis
    (module docstring), the metrics the global batch's on every rank. The
    step's `batch_axis` attribute is its BatchAxis (None with one data
    rank), whose `last` reads the gradient all-reduce."""
    _check_accum(model, mesh, grad_accum)
    axis = batch_axis(mesh)
    step = step_lib.make_train_step(model, optimizer, si_mask=si_mask,
                                    grad_accum=grad_accum,
                                    on_search=on_search, batch=axis)
    step.batch_axis = axis
    return step


def make_sharded_eval_step(model, mesh: Mesh, si_mask=None):
    """(x, y) -> the global batch's metrics, from this rank's rows."""
    return step_lib.make_eval_step(model, si_mask=si_mask,
                                   batch=batch_axis(mesh))


def build_spatial_synthesize(model, mesh: Mesh, img_h: int, img_w: int):
    """The ONE construction of the width-sharded search both spatial steps
    share (the same mask, dtype and route reading): (x_dec, y, y_dec) of
    this rank's rows, every column -> y_syn, the search over this rank's
    width shard of the side image."""
    cfg = model.ae_config
    ph, pw = (int(v) for v in cfg.y_patch_size)
    fn = spatial_lib.build_sharded_synthesize(
        mesh, ph, pw, img_h, img_w, use_mask=bool(cfg.use_gauss_mask),
        conv_dtype=sifinder_lib.sifinder_conv_dtype(cfg),
        row_chunk=spatial_lib.shard_row_chunk(
            cfg, model.centers.device.type))

    def synthesize(x_dec, y, y_dec):
        return fn(x_dec, spatial_lib.width_shard(mesh, y),
                  spatial_lib.width_shard(mesh, y_dec))

    return synthesize


def make_spatial_train_step(model, optimizer, mesh: Mesh, img_h: int,
                            img_w: int, grad_accum: int = 1,
                            on_search=None):
    """The width-sharded training step over a (data, spatial) mesh: (x, y)
    are this rank's rows of the global batch, every column (the convs run
    whole on each spatial rank); the search runs over this rank's width
    shard and its cross-shard reduction (`parallel/spatial.py`), the batch
    reductions and the gradient average over the data axis."""
    spatial_lib.check_model(model)
    _check_accum(model, mesh, grad_accum)
    axis = batch_axis(mesh)
    step = step_lib.make_train_step(
        model, optimizer, grad_accum=grad_accum, on_search=on_search,
        synthesize_fn=build_spatial_synthesize(model, mesh, img_h, img_w),
        batch=axis)
    step.batch_axis = axis
    return step


def make_spatial_eval_step(model, mesh: Mesh, img_h: int, img_w: int):
    """The width-sharded eval twin of `make_spatial_train_step`: the same
    sharded search, forward only, the global batch's metrics."""
    spatial_lib.check_model(model)
    return step_lib.make_eval_step(
        model, synthesize_fn=build_spatial_synthesize(model, mesh, img_h,
                                                      img_w),
        batch=batch_axis(mesh))

