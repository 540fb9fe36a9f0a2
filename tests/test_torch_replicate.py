"""The port's checkpoint replication (`train/checkpoint.replicate_checkpoint`
and `Experiment(replicate_to=)`), mirroring the JAX package's replication
tests (tests/test_checkpoint_manifest.py) on the port, and held against the
JAX package: a JAX-written checkpoint replicated by the port gives the same
files, byte for byte, as the JAX package's replication of it, and the JAX
package's `verify_manifest` / `verify_files` accept the port's replica.
Every comparison is exact: a replica is a byte copy.
"""

import os

import pytest

from dsin_tpu.train import checkpoint as jax_ckpt
from dsin_tpu_torch import main as port_main
from dsin_tpu_torch.train import checkpoint as port_ckpt
from dsin_tpu_torch.utils import faults as port_faults
from dsin_tpu_torch.utils.integrity import IntegrityError
from test_torch_checkpoint_faults import PARTS, _states
from test_torch_train_loop import _configs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

EXTRA = {"pc_config_sha256": "0123456789abcdef", "seed": 0,
         "buckets": [[24, 32], [32, 48]]}


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    port_faults.uninstall()
    yield
    port_faults.uninstall()


def _save(d, step=7, seed=0):
    """A port-written checkpoint of the tiny training state."""
    _, pstate = _states(step, seed)
    port_ckpt.save_checkpoint(d, pstate, manifest_extra=EXTRA)
    return pstate


def _files(d):
    out = {}
    for fname in sorted(os.listdir(d)):
        with open(os.path.join(d, fname), "rb") as f:
            out[fname] = f.read()
    return out


def test_replicate_is_a_crc_checked_copy(tmp_path):
    src, dest = str(tmp_path / "ckpt"), str(tmp_path / "peer" / "ckpt")
    state = _save(src)
    rep = port_ckpt.replicate_checkpoint(src, dest)
    assert rep["src"] == src and rep["dest"] == dest
    assert rep["files"] == 7 and rep["bytes"] > 0
    assert rep["params_digest"] == \
        port_ckpt.load_manifest(src)["params_digest"]
    assert _files(dest) == _files(src)
    manifest = port_ckpt.load_manifest(dest)
    port_ckpt.verify_files(dest, manifest)
    restored = port_ckpt.restore_partitions(dest, _states(0, 9)[1], PARTS)
    assert port_ckpt.verify_manifest(dest, restored, PARTS)["status"] \
        == "verified"
    for part in PARTS:
        assert (port_ckpt._tree_digest(restored.params[part])
                == port_ckpt._tree_digest(state.params[part]))


def test_replicate_adopts_the_prev_left_by_a_kill(tmp_path):
    src, dest = str(tmp_path / "ckpt"), str(tmp_path / "peer" / "ckpt")
    _save(src)
    os.rename(src, src + ".prev-000001")     # the kill-window state
    rep = port_ckpt.replicate_checkpoint(src, dest)
    assert rep["src"].endswith(".prev-000001")
    assert port_ckpt.load_manifest(dest)["step"] == 7


def test_replicate_refuses_a_source_without_manifest(tmp_path):
    src = str(tmp_path / "ckpt")
    _save(src)
    os.remove(os.path.join(src, port_ckpt.MANIFEST_NAME))
    with pytest.raises(port_ckpt.ManifestMismatch, match="no manifest"):
        port_ckpt.replicate_checkpoint(src, str(tmp_path / "peer"))
    with pytest.raises(FileNotFoundError):
        port_ckpt.replicate_checkpoint(str(tmp_path / "none"),
                                       str(tmp_path / "peer"))


def test_replicate_refuses_source_rot_and_leaves_no_destination(tmp_path):
    src = str(tmp_path / "ckpt")
    _save(src)
    path = os.path.join(src, "params_encoder.msgpack")
    with open(path, "r+b") as f:
        f.seek(10)
        b = f.read(1)
        f.seek(10)
        f.write(bytes([b[0] ^ 0x40]))
    with pytest.raises(IntegrityError):
        port_ckpt.replicate_checkpoint(src, str(tmp_path / "peer"))
    assert not os.path.exists(str(tmp_path / "peer"))


def test_replicate_rotates_the_destination_and_keeps_last(tmp_path):
    src, dest = str(tmp_path / "ckpt"), str(tmp_path / "peer" / "ckpt")
    _save(src, step=7)
    port_ckpt.replicate_checkpoint(src, dest)
    for step in (8, 9):
        _save(src, step=step, seed=step)
        port_ckpt.replicate_checkpoint(src, dest)
    assert port_ckpt.load_manifest(dest)["step"] == 9
    prevs = port_ckpt._prev_dirs(str(tmp_path / "peer"), "ckpt")
    assert len(prevs) == 1                      # keep_last=1
    assert port_ckpt.load_manifest(prevs[0])["step"] == 8


def test_a_kill_between_the_renames_leaves_the_old_replica(tmp_path):
    src, dest = str(tmp_path / "ckpt"), str(tmp_path / "peer" / "ckpt")
    _save(src, step=7)
    port_ckpt.replicate_checkpoint(src, dest)
    _save(src, step=8, seed=1)
    plan = port_faults.FaultPlan([port_faults.FaultSpec(site="ckpt.swap")])
    with port_faults.installed(plan):
        with pytest.raises(port_faults.InjectedFault):
            port_ckpt.replicate_checkpoint(src, dest)
    assert plan.activations["ckpt.swap"] == 1
    assert not os.path.exists(dest)
    old = port_ckpt.latest_checkpoint(dest)
    assert old == dest + ".prev-000001"
    assert jax_ckpt.latest_checkpoint(dest) == old
    manifest = port_ckpt.load_manifest(old)
    assert manifest["step"] == 7
    port_ckpt.verify_files(old, manifest)
    # the next replication takes the live name again
    port_ckpt.replicate_checkpoint(src, dest)
    assert port_ckpt.load_manifest(dest)["step"] == 8


def test_a_jax_checkpoint_replicates_to_the_same_bytes(tmp_path):
    jstate, _ = _states(7)
    src = str(tmp_path / "jax_ckpt")
    jax_ckpt.save_checkpoint(src, jstate, manifest_extra=EXTRA)
    jrep = jax_ckpt.replicate_checkpoint(src, str(tmp_path / "jax_peer"))
    prep = port_ckpt.replicate_checkpoint(src, str(tmp_path / "port_peer"))
    assert _files(str(tmp_path / "port_peer")) == \
        _files(str(tmp_path / "jax_peer")) == _files(src)
    assert {k: v for k, v in prep.items() if k != "dest"} == \
        {k: v for k, v in jrep.items() if k != "dest"}


def test_the_jax_package_accepts_the_port_replica(tmp_path):
    src, dest = str(tmp_path / "ckpt"), str(tmp_path / "peer" / "ckpt")
    _save(src)
    port_ckpt.replicate_checkpoint(src, dest)
    manifest = jax_ckpt.load_manifest(dest)
    jax_ckpt.verify_files(dest, manifest)
    jtemplate, _ = _states(0, seed=9)
    restored = jax_ckpt.restore_partitions(dest, jtemplate, PARTS)
    assert jax_ckpt.verify_manifest(dest, restored, PARTS)["status"] \
        == "verified"


def test_the_trainer_replicates_each_best_val_save(tmp_path_factory):
    """`Experiment(replicate_to=)` at the tiny configuration: every
    best-val save lands at <replicate_to>/<model_name>, byte-equal to the
    checkpoint, and the second one rotates the first aside."""
    from dsin_tpu_torch.data import synthetic
    root = tmp_path_factory.mktemp("rep_data")
    for split, path in synthetic.write_corpus(str(root), 2, 1, 1, 40, 56,
                                              seed=4).items():
        os.rename(path, os.path.join(str(root), f"{split}.txt"))
    out, peer = tmp_path_factory.mktemp("rep_out"), \
        tmp_path_factory.mktemp("rep_peer")
    ae, pc = _configs(str(root), iterations=4, validate_every=2,
                      test_model=False)
    exp = port_main.Experiment(ae, pc, out_root=str(out), device="cpu",
                               replicate_to=str(peer))
    # every validation improves, so each of the two is a best-val save
    losses = iter([2.0, 1.0])
    exp.validate = lambda batches, max_batches=None: next(losses)
    exp.train(max_val_batches=1)
    replica = os.path.join(str(peer), exp.model_name)
    assert _files(replica) == _files(exp.ckpt_dir)
    assert port_ckpt.load_meta(replica)["best_val"] == 1.0
    (prev,) = port_ckpt._prev_dirs(str(peer), exp.model_name)
    assert port_ckpt.load_meta(prev)["best_val"] == 2.0
    assert port_ckpt.load_manifest(replica)["params_digest"] == \
        port_ckpt.load_manifest(exp.ckpt_dir)["params_digest"]
