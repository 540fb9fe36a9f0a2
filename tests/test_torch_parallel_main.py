"""`dsin_tpu_torch.main` under a group of 4 gloo ranks on the CPU (a
`file://` rendezvous in tmp_path, spawned once): the mesh branch built as
the JAX package's `main.py` builds it, on a synthetic split (4 train, 4 val
and 2 test pairs at 40x56, 32x48 crops, 8x12 patches: every data rank's
shard of each split holds a pair).

  * `spatial_shards = 2`, batch 2: the data axis is the largest divisor of
    the batch beside the spatial axis, (2 data, 2 spatial); `Experiment`
    trains 2 steps (a validation at step 2, collective), rank 0 tests one
    image;
  * `spatial_shards = 1`, batch 4, through the CLI (`main.main` in the
    initialized group): every rank on the data axis;
  * `spatial_shards = 2`, batch 1, through `main.run`: the data axis is 1,
    so the mesh holds ranks 0 and 1 and ranks 2 and 3 are idle (as the
    JAX package leaves the devices past its mesh): they return at once and
    write nothing.
Every rank ends with the same parameters and statistics, bit for bit:
the spatial ranks of a data row load the same pairs in the same order
(the loader's host_id is the data index), the data rows all-reduce. Rank 0
alone writes checkpoints, sidecars, logs and test images; the other ranks'
output roots stay empty. One process with spatial_shards above its one
device raises the JAX package's ValueError.
"""

import math
import os

import numpy as np
import pytest

from dsin_tpu_torch import main as port_main
from dsin_tpu_torch.data import synthetic
from dsin_tpu_torch.parallel.launch import run_ranks
from test_torch_train_loop import _configs
from torch_parallel_parity import states_equal
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import torch_parallel_ranks as ranks


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_main")
    manifests = synthetic.write_corpus(str(root), 4, 4, 2, 40, 56, seed=2)
    for split, path in manifests.items():
        os.rename(path, os.path.join(str(root), f"{split}.txt"))
    return str(root)


def _run_all(dev, root, spatial_text, dp_text, idle_text, pc_text):
    import torch.distributed as dist

    from dsin_tpu_torch.config import parse_config
    sp = ranks.experiment_case(dev, os.path.join(root, "spatial"),
                               spatial_text, pc_text, 2, False)
    dist.barrier()
    dp = ranks.experiment_case(dev, os.path.join(root, "dp"), dp_text,
                               pc_text, 2, True)
    dist.barrier()
    out = os.path.join(root, "idle", f"rank{dist.get_rank()}")
    idle = port_main.run(parse_config(idle_text), parse_config(pc_text),
                         out_root=out, max_steps=1, max_test_images=1,
                         device=dev)
    return sp, dp, (idle, os.path.exists(out))


@pytest.fixture(scope="module")
def runs(root):
    sp_ae, pc = _configs(root, spatial_shards=2, batch_size=2,
                         test_model=True)
    dp_ae, _ = _configs(root, batch_size=4, test_model=True)
    idle_ae, _ = _configs(root, spatial_shards=2, batch_size=1,
                          test_model=True)
    for sub in ("spatial", "dp", "idle"):
        os.makedirs(os.path.join(root, sub))
    out = run_ranks(_run_all, 4, (root, str(sp_ae), str(dp_ae),
                                  str(idle_ae), str(pc)),
                    init_file=os.path.join(root, "rdzv"), threads=1,
                    timeout_s=180)
    return [r[0] for r in out], [r[1] for r in out], [r[2] for r in out]


def test_the_mesh_is_jaxs(runs):
    assert [r["coords"] for r in runs[0]] == [(0, 0), (0, 1), (1, 0),
                                              (1, 1)]


@pytest.mark.parametrize("which", [0, 1], ids=["spatial", "data"])
def test_rank_0_alone_writes(runs, which):
    written = [r["written"] for r in runs[which]]
    assert all(not w for w in written[1:]), written[1:]
    assert any(f.startswith("weights") and f.endswith("meta.json")
               for f in written[0])
    assert any(f.startswith("logs") for f in written[0])
    assert any(f.startswith("images") and f.endswith(".png")
               for f in written[0])


def test_every_rank_ends_with_the_same_state(runs):
    assert states_equal(runs[0])
    r0 = runs[0][0]["results"]
    assert r0["steps"] == 2 and math.isfinite(r0["best_val"])
    assert math.isfinite(r0["psnr"])
    for r in runs[0][1:]:
        assert r["results"]["best_val"] == r0["best_val"]


def test_one_process_refuses_more_shards_than_devices(root):
    ae, pc = _configs(root, spatial_shards=2)
    with pytest.raises(ValueError,
                       match="spatial_shards=2 exceeds the 1 available "
                             "devices"):
        port_main.Experiment(ae, pc, device="cpu")


def test_ranks_past_the_mesh_are_idle(runs):
    results = [r for r, _ in runs[2]]
    wrote = [w for _, w in runs[2]]
    assert results[2] == results[3] == {} and wrote[2:] == [False, False]
    assert results[0]["steps"] == results[1]["steps"] == 1
    assert math.isfinite(results[0]["psnr"]) and "psnr" not in results[1]
