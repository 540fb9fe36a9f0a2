"""The port's checkpoints against the JAX package's, both directions.

The port reads and writes flax's msgpack format by hand
(`dsin_tpu_torch/utils/flax_msgpack.py`), recomputes the JAX package's
parameter digest (`coding/loader.py params_digest`, its `repr(treedef)`
rendered without jax) and ports the read half of `train/checkpoint.py` plus
the save of the model partitions.

Bounds: the msgpack trees, the bytes written and the digests are exact; the
weights restored are bit-equal; the forwards of the two packages on the
same restored weights agree as in tests/test_torch_slice_entry.py: symbols
exact, images within 1e-3 of 255, bpp within rtol 1e-5 (float32 nets that
sum in another order), with every patch's top-two search margin above 1e-4
so the argmax cannot flip under that noise.
"""

import json
import os
import shutil

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from dsin_tpu.coding import loader as jax_loader
from dsin_tpu.config import parse_config as jax_parse_config
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu.ops.sifinder import gaussian_position_mask
from dsin_tpu.train import checkpoint as jax_ckpt
from dsin_tpu.train import optim as jax_optim
from dsin_tpu.train import step as jax_step
from dsin_tpu_torch import bridge
from dsin_tpu_torch.coding import loader as port_loader
from dsin_tpu_torch.data.synthetic import make_stereo_pair
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops import sifinder as sf
from dsin_tpu_torch.train import checkpoint as port_ckpt
from dsin_tpu_torch.train import step as port_step
from dsin_tpu_torch.train.optim import Optimizer
from dsin_tpu_torch.utils import flax_msgpack
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, PH, PW = 40, 48, 20, 24
PARTS = ("encoder", "decoder", "centers", "probclass", "sinet")


def _jax_configs(ae, pc):
    return jax_parse_config(str(ae)), jax_parse_config(str(pc))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Tiny configs on disk, a JAX TrainState (weights of a seeded port
    model through the bridge, a real optax opt_state) saved by the JAX
    package, and a stereo-like input pair."""
    root = tmp_path_factory.mktemp("ckpt")
    ae, pc = tiny_configs()
    ae_path, pc_path = str(root / "ae_cfg"), str(root / "pc_cfg")
    for path, cfg in ((ae_path, ae), (pc_path, pc)):
        with open(path, "w") as f:
            f.write(str(cfg))
    jae, jpc = _jax_configs(ae, pc)
    source = build_model(ae, pc, device="cpu", seed=5)
    params, batch_stats = bridge.jax_from_state_dict(source.state_dict())
    tx = jax_optim.build_optimizer(params, jae, jpc, num_training_imgs=4)
    state = jax_step.TrainState(params=params, batch_stats=batch_stats,
                                opt_state=tx.init(params),
                                step=jnp.int32(7))
    ckpt_dir = str(root / "weights" / "jax_written")
    jax_ckpt.save_checkpoint(ckpt_dir, state, manifest_extra={
        "pc_config_sha256": jax_ckpt.config_sha256(jpc), "seed": 5})
    left, right = make_stereo_pair(np.random.default_rng(1), H, W + 8)
    x = left[None, :, :W].astype(np.float32)
    y = right[None, :, 8:].astype(np.float32)
    return dict(root=root, ae=ae, pc=pc, jae=jae, jpc=jpc, ae_path=ae_path,
                pc_path=pc_path, params=params, batch_stats=batch_stats,
                state=state, ckpt=ckpt_dir, x=x, y=y)


def _leaves_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for u, v in zip(la, lb):
        assert type(u) is type(v), (type(u), type(v))
        assert np.asarray(u).dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


# -- msgpack ------------------------------------------------------------------

@pytest.mark.parametrize("fname", [f"params_{p}.msgpack" for p in PARTS]
                         + ["batch_stats.msgpack", "opt_state.msgpack"])
def test_reader_returns_flax_trees(world, fname):
    with open(os.path.join(world["ckpt"], fname), "rb") as f:
        data = f.read()
    _leaves_equal(flax_msgpack.deserialize(data),
                  flax_ser.msgpack_restore(data))


@pytest.mark.parametrize("part", PARTS + ("batch_stats",))
def test_writer_gives_flax_bytes(world, part):
    tree = (world["batch_stats"] if part == "batch_stats"
            else world["params"][part])
    want = flax_ser.msgpack_serialize(flax_ser.to_state_dict(tree))
    assert flax_msgpack.serialize(tree) == want
    with open(os.path.join(world["ckpt"], f"params_{part}.msgpack"
                           if part != "batch_stats"
                           else "batch_stats.msgpack"), "rb") as f:
        assert f.read() == want


def test_scalars_and_lists_give_flax_bytes():
    tree = {"z": np.float32(3.5), "n": 7, "neg": -1000, "big": 2 ** 40,
            "f": 1.25, "s": "x" * 40, "none": None, "flag": True,
            "ints": np.arange(300, dtype=np.int64),
            "u8": (np.arange(70000) % 7).astype(np.uint8),
            "nest": {"b": np.zeros((2, 3), np.float16), "a": [1, 2]}}
    want = flax_ser.msgpack_serialize(flax_ser.to_state_dict(tree))
    assert flax_msgpack.serialize(tree) == want
    _leaves_equal(flax_msgpack.deserialize(want),
                  flax_ser.msgpack_restore(want))


def test_bfloat16_leaves_round_trip():
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(3, 5)).astype(np.float32)
    port = {"w": torch.from_numpy(arr).to(torch.bfloat16)}
    jax_tree = {"w": jnp.asarray(arr, jnp.bfloat16)}
    data = flax_ser.msgpack_serialize(jax_tree)
    assert flax_msgpack.serialize(port) == data
    back = flax_msgpack.deserialize(data)["w"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, port["w"])
    restored = flax_ser.msgpack_restore(flax_msgpack.serialize(port))["w"]
    np.testing.assert_array_equal(np.asarray(restored, np.float32),
                                  port["w"].float().numpy())


def test_chunked_arrays_match_flax(monkeypatch):
    """Arrays above the chunk limit (2**30 bytes; 64 here) in flax's
    chunked form, both directions."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"b": np.arange(100, dtype=np.float32),
            "a": np.arange(3, dtype=np.float32)}
    data = flax_ser.msgpack_serialize(tree)
    assert flax_msgpack.serialize(tree) == data
    _leaves_equal(flax_msgpack.deserialize(data), tree)


def test_unknown_ext_and_truncation_raise():
    data = msgpack.packb({"a": msgpack.ExtType(9, b"xyz")},
                         use_bin_type=True)
    with pytest.raises(flax_msgpack.MsgpackFormatError, match="ext type 9"):
        flax_msgpack.deserialize(data)
    good = flax_msgpack.serialize({"a": np.zeros(4, np.float32)})
    with pytest.raises(flax_msgpack.MsgpackFormatError, match="truncated"):
        flax_msgpack.deserialize(good[:-3])
    with pytest.raises(flax_msgpack.MsgpackFormatError, match="trailing"):
        flax_msgpack.deserialize(good + b"\x00")
    with pytest.raises(flax_msgpack.MsgpackFormatError, match="cannot"):
        flax_msgpack.serialize({"a": object()})


# -- digest -------------------------------------------------------------------

def _digest_trees(world):
    params, stats = world["params"], world["batch_stats"]
    trees = {p: params[p] for p in PARTS}
    trees.update(batch_stats=stats, both=(params, stats))
    return trees


@pytest.mark.parametrize("rung", ["fp32", "bf16"])
@pytest.mark.parametrize("which", PARTS + ("batch_stats", "both"))
def test_params_digest_equals_jax(world, which, rung):
    tree = _digest_trees(world)[which]
    assert port_loader.treedef_repr(tree) == repr(
        jax.tree_util.tree_structure(tree))
    assert (port_loader.params_digest(tree, rung)
            == jax_loader.params_digest(tree, rung))


def test_params_digest_of_bfloat16_leaves(world):
    tree = world["params"]["decoder"]
    as_jax = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    tree)
    as_port = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a).to(torch.bfloat16), tree)
    assert (port_loader.params_digest(as_port, "bf16")
            == jax_loader.params_digest(as_jax, "bf16"))


# -- JAX writes, the port reads -----------------------------------------------

def _margins_clear(model, x, y):
    with torch.no_grad():
        x_dec = model.decode(model.encode(torch.from_numpy(x)).qbar)
        y_dec = model.decode(model.encode(torch.from_numpy(y)).qbar)
    res = sf.search_single(x_dec[0], torch.from_numpy(y[0]), y_dec[0],
                           sf.gaussian_position_mask(H, W, PH, PW), PH, PW)
    top2 = torch.topk(res.score_map.reshape(-1, res.score_map.shape[-1]),
                      2, dim=0).values
    return float((top2[0] - top2[1]).min()) > 1e-4


def _forwards_agree(model, jax_params, jax_stats, world):
    x, y = world["x"], world["y"]
    assert _margins_clear(model, x, y)
    mask = gaussian_position_mask(H, W, PH, PW)
    got = port_step.make_inference_step(model, si_mask=mask)(x, y)
    jmodel = JaxDSIN(*_jax_configs(model.ae_config, model.pc_config))
    state = jax_step.TrainState(params=jax_params, batch_stats=jax_stats,
                                opt_state=(), step=jnp.int32(0))
    infer = jax_step.make_inference_step(jmodel, si_mask=jnp.asarray(mask))
    want = jax.device_get(infer(state, x, y))
    np.testing.assert_array_equal(got["symbols"].numpy(), want["symbols"])
    for key in ("x_dec", "x_with_si", "y_syn"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=1e-3, err_msg=key)
    np.testing.assert_allclose(float(got["bpp"]), float(want["bpp"]),
                               rtol=1e-5)


def test_jax_checkpoint_loads_into_the_port(world):
    model = port_loader.load_model_state(
        world["ae_path"], world["pc_path"], ckpt_dir=world["ckpt"],
        need_sinet=True, device="cpu")
    params, stats = bridge.jax_from_state_dict(model.state_dict())
    _leaves_equal(params, world["params"])
    _leaves_equal(stats, world["batch_stats"])
    state = port_ckpt.restore_partitions(
        world["ckpt"], port_ckpt.state_from_model(model), PARTS)
    info = port_ckpt.verify_manifest(world["ckpt"], state, PARTS,
                                     pc_config=world["pc"])
    assert info["status"] == "verified"
    assert info["manifest"]["params_digest"] == port_loader.params_digest(
        (state.params, state.batch_stats))
    assert port_ckpt.verify_files(world["ckpt"], info["manifest"])["files"] \
        == 7
    _forwards_agree(model, world["params"], world["batch_stats"], world)


def test_port_resave_of_a_jax_checkpoint_is_byte_identical(world, tmp_path):
    model = port_loader.load_model_state(
        world["ae_path"], world["pc_path"], ckpt_dir=world["ckpt"],
        need_sinet=True, device="cpu")
    out = str(tmp_path / "resaved")
    port_ckpt.save_checkpoint(out, port_ckpt.state_from_model(model, 7),
                              manifest_extra={
                                  "pc_config_sha256": port_ckpt.config_sha256(
                                      world["pc"]), "seed": 5})
    for part in PARTS:
        name = f"params_{part}.msgpack"
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(world["ckpt"], name), "rb") as b:
            assert a.read() == b.read(), name
    mine = port_ckpt.load_manifest(out)
    theirs = jax_ckpt.load_manifest(world["ckpt"])
    theirs["files"].pop("opt_state.msgpack")
    assert mine == theirs
    assert sorted(os.listdir(out)) == sorted(
        n for n in os.listdir(world["ckpt"]) if n != "opt_state.msgpack")


# -- the port writes, JAX reads -----------------------------------------------

def test_port_checkpoint_restores_in_jax(world, tmp_path):
    ae, pc = world["ae"], world["pc"]
    model = build_model(ae, pc, device="cpu", seed=11)
    ckpt_dir = str(tmp_path / "port_written")
    port_ckpt.save_checkpoint(ckpt_dir, port_ckpt.state_from_model(model),
                              manifest_extra={
                                  "pc_config_sha256":
                                      port_ckpt.config_sha256(pc),
                                  "seed": 11})
    jae = world["jae"].replace(load_model=True, load_train_step=False,
                               train_model=False, test_model=True)
    zeros = jax.tree_util.tree_map(np.zeros_like, (world["params"],
                                                   world["batch_stats"]))
    template = jax_step.TrainState(params=zeros[0], batch_stats=zeros[1],
                                   opt_state=(), step=jnp.int32(0))
    restored = jax_ckpt.restore_for_mode(ckpt_dir, template, jae)
    info = jax_ckpt.verify_manifest(ckpt_dir, restored, PARTS,
                                    pc_config=world["jpc"])
    assert info["status"] == "verified"
    want = bridge.jax_from_state_dict(model.state_dict())
    _leaves_equal(jax.tree_util.tree_map(np.asarray, restored.params),
                  want[0])
    _forwards_agree(model, restored.params, restored.batch_stats, world)


# -- typed failures -----------------------------------------------------------

def _copy(world, tmp_path, name="copy"):
    dst = str(tmp_path / name)
    shutil.copytree(world["ckpt"], dst)
    return dst


def _load(world, ckpt, need_sinet=True):
    return port_loader.load_model_state(world["ae_path"], world["pc_path"],
                                        ckpt_dir=ckpt, need_sinet=need_sinet,
                                        device="cpu")


def test_a_tampered_partition_is_refused(world, tmp_path):
    ckpt = _copy(world, tmp_path)
    path = os.path.join(ckpt, "params_decoder.msgpack")
    data = bytearray(open(path, "rb").read())
    data[-5] ^= 0x01             # inside the last array's float data
    open(path, "wb").write(bytes(data))
    with pytest.raises(port_ckpt.ManifestMismatch, match="'decoder' digest"):
        _load(world, ckpt)
    template = jax_step.TrainState(
        params=world["params"], batch_stats=world["batch_stats"],
        opt_state=(), step=jnp.int32(0))
    with pytest.raises(jax_ckpt.ManifestMismatch, match="'decoder' digest"):
        jax_loader_state = jax_ckpt.restore_partitions(ckpt, template, PARTS)
        jax_ckpt.verify_manifest(ckpt, jax_loader_state, PARTS)


def test_a_missing_sinet_partition_is_refused(world, tmp_path):
    ckpt = _copy(world, tmp_path)
    os.remove(os.path.join(ckpt, "params_sinet.msgpack"))
    with pytest.raises(FileNotFoundError, match="no partition 'sinet'"):
        _load(world, ckpt)
    _load(world, ckpt, need_sinet=False)        # the AE partitions suffice


def test_a_future_manifest_version_is_refused(world, tmp_path):
    ckpt = _copy(world, tmp_path)
    path = os.path.join(ckpt, "manifest.json")
    manifest = json.load(open(path))
    manifest["manifest_version"] = port_ckpt.MANIFEST_VERSION + 1
    json.dump(manifest, open(path, "w"))
    with pytest.raises(port_ckpt.ManifestMismatch, match="manifest_version"):
        _load(world, ckpt)


def test_another_pc_config_is_refused(world, tmp_path):
    pc_path = str(tmp_path / "pc_other")
    with open(pc_path, "w") as f:
        f.write(str(world["pc"].replace(lr_initial=2e-4)))
    with pytest.raises(port_ckpt.ManifestMismatch, match="probability-model"):
        port_loader.load_model_state(world["ae_path"], pc_path,
                                     ckpt_dir=world["ckpt"], device="cpu")


def test_a_legacy_checkpoint_loads_with_a_warning(world, tmp_path):
    ckpt = _copy(world, tmp_path)
    os.remove(os.path.join(ckpt, "manifest.json"))
    with pytest.warns(UserWarning, match="predates manifest.json"):
        model = _load(world, ckpt)
    _leaves_equal(bridge.jax_from_state_dict(model.state_dict())[0],
                  world["params"])


def test_corrupt_meta_and_manifest_raise_integrity_error(world, tmp_path):
    ckpt = _copy(world, tmp_path)
    for name, fn in (("meta.json", port_ckpt.load_meta),
                     ("manifest.json", port_ckpt.load_manifest)):
        with open(os.path.join(ckpt, name), "w") as f:
            f.write("{trunc")
        with pytest.raises(port_ckpt.IntegrityError, match="corrupt"):
            fn(ckpt)


def test_latest_checkpoint_resolves_a_kill_between_the_renames(
        world, tmp_path, monkeypatch):
    model = build_model(world["ae"], world["pc"], device="cpu", seed=1)
    ckpt = str(tmp_path / "m")
    first = port_ckpt.state_from_model(model, step=1)
    port_ckpt.save_checkpoint(ckpt, first)
    real_rename = os.rename

    def killed(src, dst):
        if ".tmp-" in src:
            raise KeyboardInterrupt("killed between the renames")
        real_rename(src, dst)

    monkeypatch.setattr(os, "rename", killed)
    with pytest.raises(KeyboardInterrupt):
        port_ckpt.save_checkpoint(ckpt, first._replace(step=2))
    monkeypatch.setattr(os, "rename", real_rename)
    assert not os.path.exists(ckpt)
    resolved = port_ckpt.latest_checkpoint(ckpt)
    assert resolved == ckpt + ".prev-000001"
    assert jax_ckpt.latest_checkpoint(ckpt) == resolved
    assert port_ckpt.load_meta(resolved)["step"] == 1
    port_ckpt.save_checkpoint(ckpt, first._replace(step=3), keep_last=1)
    assert port_ckpt.load_meta(ckpt)["step"] == 3
    assert [n for n in os.listdir(tmp_path) if ".prev-" in n] == [
        "m.prev-000001"]


def test_what_waits_for_other_slices_raises(world, tmp_path):
    model = build_model(world["ae"], world["pc"], device="cpu", seed=1)
    # canary goldens are validated now that the quality module is ported:
    # a malformed entry is refused at save, as the JAX package refuses it
    with pytest.raises(ValueError, match="canary"):
        port_ckpt.save_checkpoint(str(tmp_path / "c"),
                                  port_ckpt.state_from_model(model),
                                  manifest_extra={"canary": {}})
    assert not os.path.exists(str(tmp_path / "c"))
    # load_train_step restores an optimizer state, so it needs one to
    # restore into; given one, the JAX checkpoint's opt_state restores
    resume = world["ae"].replace(load_train_step=True, train_model=False,
                                 test_model=True)
    with pytest.raises(ValueError, match="optimizer state"):
        port_ckpt.restore_for_mode(
            world["ckpt"], port_ckpt.state_from_model(model), resume)
    optimizer = Optimizer(model, world["ae"], world["pc"], 10)
    state = port_ckpt.restore_for_mode(
        world["ckpt"], port_ckpt.state_from_model(model, 0, optimizer),
        resume)
    port_ckpt.load_state(model, state, optimizer)
    assert optimizer.step == port_ckpt.load_meta(world["ckpt"])["step"]
