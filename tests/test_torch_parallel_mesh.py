"""The port's (data, spatial) mesh (`dsin_tpu_torch/parallel/mesh.py`)
against the JAX package's `parallel/mesh.py` and `main.py`, on the CPU.

The arithmetic is held exactly: the grid of ranks against JAX's `make_mesh`
device grid, its typed errors word for word, and the data axis against the
JAX `main.py` auto-size, over a grid of device counts, spatial axes and
batch sizes. The backend and device refusals need no process group. One
group of 4 gloo ranks (a `file://` rendezvous in tmp_path, no port), spawned
once, shows the rest at spatial 2: coordinates, the axes' ranks, each
rank's rows and columns of a batch, gathers in axis order,
`replicate_state` from rank 0, the batch axis's global means with their
gradient (the all-reduce's backward is the same all-reduce, then the
gradients are averaged over the data axis: each rank's gradient of its
local x is that of the global mean), and the distortions and MS-SSIM of a
batch held in blocks against one process's.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from dsin_tpu.parallel import mesh as jax_mesh
from dsin_tpu_torch.config import parse_config
from dsin_tpu_torch.ops import metrics
from dsin_tpu_torch.parallel import mesh as mesh_lib
from dsin_tpu_torch.parallel.launch import run_ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import torch_parallel_ranks as ranks


def _jax_data_axis(batch_size, n_devices, spatial):
    """The JAX package's main.py:125-127, verbatim."""
    max_data = max(n_devices // spatial, 1)
    return max(d for d in range(1, max_data + 1) if batch_size % d == 0)


@pytest.mark.parametrize("num_devices", [0, 1, 2, 3, 4, 6, 8])
def test_the_grid_and_its_errors_are_jaxs(num_devices):
    devices = jax.devices()
    ids = {d: i for i, d in enumerate(devices)}
    for spatial in range(0, 10):
        try:
            want = jax_mesh.make_mesh(num_devices=num_devices,
                                      spatial=spatial)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                mesh_lib.mesh_grid(len(devices[:num_devices]), spatial)
            assert str(got.value) == str(e)
            continue
        grid = mesh_lib.mesh_grid(len(devices[:num_devices]), spatial)
        assert grid.tolist() == [[ids[d] for d in row]
                                 for row in want.devices.tolist()]
        assert dict(want.shape) == {mesh_lib.DATA_AXIS: grid.shape[0],
                                    mesh_lib.SPATIAL_AXIS: grid.shape[1]}


def test_the_data_axis_is_sized_as_jaxs():
    for batch, n, spatial in itertools.product(range(1, 13), range(1, 17),
                                               range(1, 9)):
        assert mesh_lib.data_axis_size(batch, n, spatial) == \
            _jax_data_axis(batch, n, spatial), (batch, n, spatial)


def test_one_process_is_a_one_rank_mesh():
    mesh = mesh_lib.make_mesh()
    assert mesh.coords == (0, 0) and mesh.size == 1 and mesh.member
    t = torch.arange(3.0)
    assert torch.equal(mesh.all_gather(t, "spatial"), t[None])
    with pytest.raises(ValueError, match="not divisible by spatial=2"):
        mesh_lib.make_mesh(spatial=2)


@pytest.mark.parametrize("backend,device,local_world,cards,error,match", [
    ("nccl", "cpu", 1, None, ValueError, "backend='gloo' on the CPU"),
    ("nccl", "cuda:0", 4, 1, mesh_lib.SharedDeviceError, "backend='gloo'"),
    ("nccl", "cuda:0", 2, 8, mesh_lib.SharedDeviceError, "one device per"),
    ("nccl", "cuda", 4, 1, mesh_lib.SharedDeviceError, "backend='gloo'"),
    ("gloo", "cuda", 4, 1, ValueError, "explicit device='cuda:0'"),
    ("mpi", "cpu", 1, None, ValueError, "expected one of"),
])
def test_backend_and_device_refusals(backend, device, local_world, cards,
                                     error, match):
    """Nothing switches backend or device: NCCL on the CPU or on a card
    shared by the host's ranks raises naming gloo, more ranks than cards
    under 'cuda' raises naming an explicit card."""
    with pytest.raises(error, match=match):
        mesh_lib.rank_device(backend, device, 0, local_world, cards)


@pytest.mark.parametrize("backend,device,local_rank,local_world,cards,want", [
    ("gloo", "cpu", 3, 4, None, "cpu"),
    ("gloo", "cuda:0", 3, 4, 1, "cuda:0"),
    ("nccl", "cuda", 3, 4, 4, "cuda:3"),
    ("nccl", "cuda:0", 0, 1, 1, "cuda:0"),
])
def test_rank_devices(backend, device, local_rank, local_world, cards, want):
    assert mesh_lib.rank_device(backend, device, local_rank, local_world,
                                cards) == torch.device(want)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    init = str(tmp_path_factory.mktemp("mesh_rdzv") / "rdzv")
    return run_ranks(ranks.mesh_facts, 4, (2,), init_file=init, threads=1,
                     timeout_s=120)


def test_coordinates_and_axes(four_ranks):
    """Rank r at (r // 2, r % 2); a gather over an axis is its ranks in
    axis order: the data axis a spatial column, the spatial axis a data
    row."""
    assert [r["coords"] for r in four_ranks] == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
    assert [r["gathered"] for r in four_ranks] == [
        {"data": [0, 2], "spatial": [0, 1]},
        {"data": [1, 3], "spatial": [0, 1]},
        {"data": [0, 2], "spatial": [2, 3]},
        {"data": [1, 3], "spatial": [2, 3]}]


def test_rows_and_columns(four_ranks):
    batch = np.arange(8 * 2 * 6 * 1, dtype=np.float32).reshape(8, 2, 6, 1)
    for r in four_ranks:
        d, s = r["coords"]
        assert np.array_equal(r["rows"], batch[4 * d:4 * d + 4])
        assert np.array_equal(r["cols"], batch[4 * d:4 * d + 4, :,
                                               3 * s:3 * s + 3])


def test_replicate_state_broadcasts_rank_0(four_ranks):
    for r in four_ranks:
        assert np.array_equal(r["weight"], np.zeros((2, 3), np.float32))
        assert np.array_equal(r["bias"], np.zeros(2, np.float32))


def test_batch_axis_means_and_their_gradient(four_ranks):
    """Data row d holds x = d + 1 (2 rows of 3): the global x is rows of 1
    and rows of 2. mean(x^2) = 2.5; the column means (1.5, 1.5, 1.5) and
    (2.5, ...). The loss mean(x^2) + sum(mean(x)) + sum(mean(x^2)) has
    d/dx = 2x / 12 + 1 / 4 + 2x / 4 on the global batch."""
    for r in four_ranks:
        d = r["coords"][0]
        x = d + 1.0
        assert r["mean"] == 2.5
        np.testing.assert_allclose(r["means"][0], [1.5] * 3, rtol=1e-7)
        np.testing.assert_allclose(r["means"][1], [2.5] * 3, rtol=1e-7)
        # the rank's backward gives (data ranks) x the global gradient,
        # which BatchAxis.average_grads divides back
        np.testing.assert_allclose(
            r["grad"] / 2, np.full((2, 3), 2 * x / 12 + 0.25 + 2 * x / 4),
            rtol=1e-6)


def test_distortions_over_the_data_axis(four_ranks):
    """MAE, MSE, PSNR (per image, then the batch mean) and MS-SSIM (each
    level's means over the whole batch) of a batch of 4 whose rows the 2
    data rows hold in blocks equal one process's on the whole batch, to
    float32's summation order (rtol 1e-6)."""
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (4, 24, 24, 3)).astype(np.float32))
    out = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 255, (4, 24, 24, 3)).astype(np.float32))
    cfg = parse_config("distortion_to_minimize = 'ms_ssim'\nK_ms_ssim = 5000")
    dist = metrics.compute_distortions(cfg, img, out, True)
    want = [float(getattr(dist, k)) for k in (
        "mae", "mse", "psnr", "ms_ssim", "d_loss_scaled")]
    for r in four_ranks:
        np.testing.assert_allclose(r["distortions"], want, rtol=1e-6)
