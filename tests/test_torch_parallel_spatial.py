"""The port's width-sharded search (`dsin_tpu_torch/parallel/spatial.py`)
against the JAX package's `parallel/spatial.py`, on the CPU.

One group of 8 gloo ranks, a (2 data, 4 spatial) mesh, spawned once for
the file (a `file://` rendezvous in tmp_path, no port); the JAX side runs
on the 8 virtual CPU devices of the test platform, the same mesh. At 16x96
with 8x12 patches (tests/test_spatial.py's geometry), global batches of 2:
the Gaussian prior and no prior, a match planted across the shard-0 /
shard-1 boundary (only the halo lets shard 0 see the whole window), and the
row-chunked shard search (`row_chunk` 3: the map's 9 rows in 3 chunks).
Indices are held EXACTLY: every rank's y_syn bit-equal to JAX's for its
rows, and its winning global flat indices to the unsharded search's (the
winner rule is the first maximum of the whole map). The width-sharded
inference step is held against the port's one-rank inference step on the
same rows (y_syn exactly; siNet's output within 1e-4 of 255, its input the
same y_syn), and the typed refusals need no group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsin_tpu.ops import sifinder as jax_sifinder
from dsin_tpu.parallel import mesh as jax_mesh
from dsin_tpu.parallel import spatial as jax_spatial
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.parallel import mesh as mesh_lib
from dsin_tpu_torch.parallel import spatial as spatial_lib
from dsin_tpu_torch.parallel.launch import run_ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import torch_parallel_ranks as ranks

H, W = 16, 96
PH, PW = 8, 12
P_CNT = (H // PH) * (W // PW)
WC = W - PW + 1
ROW_CHUNK = 3


def _pair(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32),
            rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32))


def _straddling():
    """An exact copy of x's patch 3 planted at (4, 18) in y: columns 18..29
    straddle the 24-wide shards 0 and 1."""
    x, y = _pair(5)
    patch_idx, r0, c0 = 3, 4, 18
    pr = (patch_idx // (W // PW)) * PH
    pc = (patch_idx % (W // PW)) * PW
    y[0, r0:r0 + PH, c0:c0 + PW] = x[0, pr:pr + PH, pc:pc + PW]
    return x, y, (pr, pc, r0 * WC + c0, patch_idx)


CASES = {
    "mask": (_pair(0), True, None),
    "no_mask": (_pair(0), False, None),
    "straddle": (_straddling()[:2], False, None),
    "row_chunk": (_pair(1), True, ROW_CHUNK),
}


@pytest.fixture(scope="module")
def jax_mesh_8():
    assert len(jax.devices()) >= 8
    return jax_mesh.make_mesh(num_devices=8, spatial=4)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case on the 8 ranks, plus the inference step: one spawn."""
    ae, pc = tiny_configs(2)
    ae = ae.replace(crop_size=(H, W), y_patch_size=(PH, PW))
    x, y = _pair(9)
    init = str(tmp_path_factory.mktemp("spatial_rdzv") / "rdzv")
    cases = [(x_, y_, y_, PH, PW, mask, rc)
             for (x_, y_), mask, rc in CASES.values()]
    out = run_ranks(_all_cases, 8, (cases, str(ae), str(pc), x, y),
                    init_file=init, threads=1, timeout_s=180)
    return {name: [r[0][i] for r in out] for i, name in enumerate(CASES)}, \
        [r[1] for r in out]


def _all_cases(dev, cases, ae_text, pc_text, x, y):
    return (ranks.search_cases(dev, cases),
            ranks.inference_case(dev, ae_text, pc_text, x, y, 3))


def _jax_syn(jax_mesh_8, name):
    (x, y), use_mask, row_chunk = CASES[name]
    if row_chunk is None:
        fn = jax_spatial.make_spatial_synthesize(jax_mesh_8, PH, PW, H, W,
                                                 use_mask=use_mask)
        return np.asarray(fn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(y)))
    from jax.sharding import NamedSharding, PartitionSpec as P
    syn = jax_spatial.build_synthesize_shmap(jax_mesh_8, PH, PW, H, W,
                                             use_mask=use_mask,
                                             row_chunk=row_chunk)
    x_sh = NamedSharding(jax_mesh_8, P("data", None, None, None))
    y_sh = NamedSharding(jax_mesh_8, P("data", None, "spatial", None))
    fn = jax.jit(syn, in_shardings=(x_sh, y_sh, y_sh), out_shardings=x_sh)
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(y)))


def _unsharded_flat(name):
    """JAX's unsharded search's winning flat indices, per pair."""
    (x, y), use_mask, _ = CASES[name]
    mask = (jnp.asarray(jax_sifinder.gaussian_position_mask(H, W, PH, PW))
            if use_mask else None)
    return np.stack([np.asarray(jax_sifinder.search_single(
        jnp.asarray(x[i]), jnp.asarray(y[i]), jnp.asarray(y[i]), mask,
        PH, PW, False).best_flat) for i in range(2)])


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_search_matches_jax_exactly(results, jax_mesh_8, name):
    want = _jax_syn(jax_mesh_8, name)
    flat = _unsharded_flat(name)
    for coords, y_syn, best_flat in results[0][name]:
        d = coords[0]
        assert np.array_equal(y_syn, want[d:d + 1]), (name, coords)
        assert np.array_equal(best_flat, flat[d:d + 1]), (name, coords)


def test_the_straddling_match_is_found(results):
    x, _, (pr, pc, flat, patch_idx) = _straddling()
    for coords, y_syn, best_flat in results[0]["straddle"]:
        if coords[0] == 0:
            assert int(best_flat[0, patch_idx]) == flat
            np.testing.assert_array_equal(y_syn[0, pr:pr + PH, pc:pc + PW],
                                          x[0, pr:pr + PH, pc:pc + PW])


def test_spatial_inference_step_matches_one_rank(results):
    for got in results[1]:
        for k in ("y_syn", "bpp"):
            assert np.array_equal(*got[k]), k
        np.testing.assert_allclose(*got["x_with_si"], rtol=0, atol=1e-4 * 255)


def _mesh(spatial, index=0):
    return mesh_lib.Mesh(mesh_lib.mesh_grid(spatial, spatial), index,
                         {"data": None, "spatial": None})


def test_typed_refusals():
    with pytest.raises(ValueError, match="must divide evenly into 5 shards"):
        spatial_lib.build_sharded_search(_mesh(5), PH, PW, H, W)
    with pytest.raises(ValueError, match="12-wide patches"):
        spatial_lib.build_sharded_search(_mesh(2), PH, PW, H, 100)
    with pytest.raises(ValueError, match="narrower than the search halo 23"):
        spatial_lib.build_sharded_search(_mesh(8), PH, 24, H, W)
    ae, pc = tiny_configs(2)
    from dsin_tpu_torch.models.dsin import build_model
    model = build_model(ae.replace(crop_size=(H, W), y_patch_size=(PH, PW),
                                   use_L2andLAB=True), pc, device="cpu")
    with pytest.raises(ValueError, match="Pearson-only"):
        spatial_lib.make_spatial_inference_step(model, _mesh(4), H, W)


@pytest.mark.parametrize("impl,device,want", [
    ("auto", "cpu", None), ("torch", "cpu", None), ("tiled", "cpu", 32),
    ("auto", "cuda", 32), ("torch", "cuda", None), ("kernel", "cuda", None)])
def test_the_shard_route(impl, device, want):
    """The JAX package tiles its shards under 'xla_tiled' (the port's
    'tiled'); on a card 'auto' tiles too, never materializing the map."""
    ae, _ = tiny_configs(2)
    assert spatial_lib.shard_row_chunk(ae.replace(sifinder_impl=impl),
                                       device) == want
