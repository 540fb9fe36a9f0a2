"""The (data, spatial) mesh of a run over `torch.distributed` (counterpart
of the JAX package's `parallel/mesh.py`).

One process per device (a rank), as PyTorch runs data parallelism. The
ranks [0, n) of the default process group are laid out n // spatial by
spatial: rank r sits at (r // spatial, r % spatial). Each data row (the
ranks of one data index) gets a process group for the spatial axis, each
spatial column (the ranks of one spatial index) one for the data axis:

  * 'data'    - batch axis: each data row holds its own rows of the global
                batch; cross-rank reductions of the global batch and the
                gradient all-reduce run over it;
  * 'spatial' - image width: the ranks of a data row split the patch
                search's side image by columns (`parallel/spatial.py`).

Ranks past n (a mesh smaller than the group, as `main.py` sizes it) are not
members: they hold no rows and take part in no mesh collective.

Backends are explicit: NCCL where each rank owns its own card, gloo on the
CPU and for several ranks sharing one card. NCCL asked to run two ranks on
one device raises `SharedDeviceError`, naming gloo; nothing switches the
backend or the device. The collectives used here are `all_reduce`,
`broadcast` and `all_gather`, which gloo takes on CUDA tensors as on CPU
ones (torch 2.11 on the H100 machine, probed by chip_smoke phase 15; it
copies through the host itself); point-to-point `send`/`recv`, which gloo
does not take on CUDA tensors, is not used.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 300.0


class SharedDeviceError(ValueError):
    """NCCL asked to run several ranks on one device."""


def mesh_grid(num_devices: int, spatial: int = 1) -> np.ndarray:
    """Ranks [0, num_devices) as a (num_devices // spatial, spatial) grid,
    with the JAX package's `make_mesh` errors."""
    n = int(num_devices)
    if n < 1:
        raise ValueError(
            "cannot build a mesh over zero devices — num_devices/devices "
            "selected an empty set")
    if spatial < 1 or n % spatial != 0:
        raise ValueError(
            f"device count {n} is not divisible by spatial={spatial}: "
            f"the (data, spatial) mesh needs n_devices to be a positive "
            f"multiple of the spatial axis")
    return np.arange(n).reshape(n // spatial, spatial)


def data_axis_size(batch_size: int, num_devices: int, spatial: int) -> int:
    """The data axis beside `spatial`, as the JAX package's `main.py` sizes
    it: the largest divisor of `batch_size` that fits the devices left."""
    max_data = max(num_devices // spatial, 1)
    return max(d for d in range(1, max_data + 1) if batch_size % d == 0)


def world() -> tuple:
    """(rank, world size) of the default process group; (0, 1) when none
    is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """This rank's place in a (data, spatial) mesh and the process groups of
    its axes. `groups[axis]` is None where the axis holds this rank alone
    (no collective runs there)."""

    def __init__(self, grid: np.ndarray, rank: int,
                 groups: Dict[str, object], whole_group=None):
        self.grid = grid
        self.rank = rank
        self.shape = {DATA_AXIS: grid.shape[0], SPATIAL_AXIS: grid.shape[1]}
        self.member = rank < grid.size
        self.coords = ((rank // grid.shape[1], rank % grid.shape[1])
                       if self.member else None)
        self.groups = groups
        self.whole_group = whole_group

    @property
    def size(self) -> int:
        return int(self.grid.size)

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def spatial_index(self) -> int:
        return self.coords[1]

    def all_gather(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        """(axis size, *tensor.shape): every rank's `tensor` along `axis`,
        in axis order."""
        group = self.groups[axis]
        if group is None:
            return tensor[None]
        src = tensor.contiguous()
        out = [torch.empty_like(src) for _ in range(self.shape[axis])]
        dist.all_gather(out, src, group=group)
        return torch.stack(out)

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0):
        """Broadcast `tensors` in place from global rank `src` over the
        mesh's ranks: one collective per dtype (each a flat copy)."""
        if self.size == 1:
            return
        by_dtype: Dict[tuple, list] = {}
        for t in tensors:
            by_dtype.setdefault((t.dtype, t.device), []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=src, group=self.whole_group)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def make_mesh(num_devices: Optional[int] = None, spatial: int = 1) -> Mesh:
    """The (data, spatial) mesh over the first `num_devices` ranks of the
    default process group (all of them by default; one process and rank 0
    when none is initialized). Every rank of the group must call it, in
    the same order as its other `new_group` calls: it creates the axes'
    groups."""
    rank, size = world()
    ranks = list(range(size))
    if num_devices is not None:
        ranks = ranks[:num_devices]
    grid = mesh_grid(len(ranks), spatial)
    groups = {DATA_AXIS: None, SPATIAL_AXIS: None}
    if size == 1:
        return Mesh(grid, rank, groups)
    whole = (None if grid.size == size
             else dist.new_group(ranks=list(range(grid.size))))
    # every rank creates every group, in one order (new_group is collective)
    for d in range(grid.shape[0]):
        row = [int(r) for r in grid[d]]
        g = dist.new_group(ranks=row) if len(row) > 1 else None
        if rank in row:
            groups[SPATIAL_AXIS] = g
    for s in range(grid.shape[1]):
        col = [int(r) for r in grid[:, s]]
        g = dist.new_group(ranks=col) if len(col) > 1 else None
        if rank in col:
            groups[DATA_AXIS] = g
    return Mesh(grid, rank, groups, whole)


def rank_device(backend: str, device, local_rank: int, local_world: int,
                device_count: Optional[int]) -> torch.device:
    """The device this rank runs on, or the refusal of the request, before
    any process group or device is touched: 'cpu'; an explicit 'cuda:i'
    (every rank of the host on card i); or 'cuda', which is cuda:LOCAL_RANK
    and needs a card per rank of the host (`device_count`)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    dev = torch.device(device)
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError(f"backend 'nccl' runs on CUDA devices, not "
                             f"{dev}: ask for backend='gloo' on the CPU")
        return dev
    shared = (local_world > 1 if dev.index is not None
              else device_count is not None and local_world > device_count)
    if shared and backend == "nccl":
        raise SharedDeviceError(
            f"backend 'nccl' cannot run {local_world} ranks of this host on "
            f"{dev if dev.index is not None else f'{device_count} card(s)'}"
            f": NCCL needs one device per rank; ask for backend='gloo' and "
            f"an explicit device such as 'cuda:0' to share a card")
    if dev.index is None:
        if shared:
            raise ValueError(
                f"{local_world} ranks on this host, {device_count} card(s): "
                f"run one rank per card, or pass an explicit device='cuda:0' "
                f"with backend='gloo' to share one")
        dev = torch.device("cuda", local_rank)
    return dev


def init_distributed(backend: str, device="cuda",
                     init_method: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, and MASTER_ADDR/MASTER_PORT
    for the default `env://`; or pass a `file://` `init_method`) and return
    this rank's device (`rank_device`). `backend` is 'nccl' or 'gloo' and
    is never chosen here: NCCL on a card shared by this host's ranks raises
    `SharedDeviceError`."""
    env = os.environ
    local_rank = int(env.get("LOCAL_RANK", env.get("RANK", 0)))
    local_world = int(env.get("LOCAL_WORLD_SIZE", env.get("WORLD_SIZE", 1)))
    wants_card = torch.device(device).type == "cuda"
    dev = rank_device(backend, device, local_rank, local_world,
                      torch.cuda.device_count() if wants_card else None)
    missing = [k for k in ("RANK", "WORLD_SIZE") if k not in env]
    if missing:
        raise ValueError(f"a distributed run needs torchrun's environment "
                         f"(RANK, WORLD_SIZE, LOCAL_RANK): {missing} unset")
    rank, size = int(env["RANK"]), int(env["WORLD_SIZE"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of host batches (N, ...): the block of N / data rows
    at its data index (the JAX package shards the batch over 'data' in
    blocks)."""
    out = []
    d, n_data = mesh.data_index, mesh.shape[DATA_AXIS]
    for a in arrays:
        if a.shape[0] % n_data:
            raise ValueError(f"batch {a.shape[0]} does not split over the "
                             f"{n_data} ranks of the data axis")
        rows = a.shape[0] // n_data
        out.append(a[d * rows:(d + 1) * rows])
    return tuple(out) if len(out) > 1 else out[0]


def shard_images(mesh: Mesh, *arrays):
    """This rank's rows and width columns of host (N, H, W, C) batches:
    its data index's block of rows, its spatial index's block of
    columns."""
    out = []
    s, n_sp = mesh.spatial_index, mesh.shape[SPATIAL_AXIS]
    rows = shard_batch(mesh, *arrays)
    for a in (rows,) if len(arrays) == 1 else rows:
        if a.shape[2] % n_sp:
            raise ValueError(f"width {a.shape[2]} does not split over the "
                             f"{n_sp} ranks of the spatial axis")
        cols = a.shape[2] // n_sp
        out.append(a[:, :, s * cols:(s + 1) * cols])
    return tuple(out) if len(out) > 1 else out[0]


def replicate_state(mesh: Mesh, model: torch.nn.Module,
                    optimizer=None) -> None:
    """Make every rank of the mesh hold rank 0's parameters, batch-norm
    statistics and optimizer state (moments, counts and step)."""
    if mesh.size == 1:
        return
    tensors = list(model.parameters()) + list(model.buffers())
    counts = []
    if optimizer is not None:
        for group in optimizer.groups.values():
            for slot in group.slots.values():
                tensors.extend(slot[n] for n in group.names)
            counts.append(group.count)
        counts.append(optimizer.step)
    with torch.no_grad():
        mesh.broadcast_(tensors)
    if counts:
        dev = next(model.parameters()).device
        held = torch.tensor(counts, dtype=torch.int64, device=dev)
        mesh.broadcast_([held])
        values = [int(v) for v in held.cpu()]
        for group, value in zip(optimizer.groups.values(), values):
            group.count = value
        optimizer.step = values[-1]
