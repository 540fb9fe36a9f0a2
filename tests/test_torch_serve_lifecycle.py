"""The model lifecycle of the port's service against the JAX package's, on
the CPU: one JAX `CompressionService` and one port service (the tiny
configuration of tests/test_train_step.py, bucket (16, 24), SI and quality
on) serve checkpoint A, both written by the JAX package, and both swap to
checkpoint B and roll back.

Held exactly: encode streams byte-equal before the swap, after it and after
the rollback; the served digest after a swap at fp32, bf16 and int8 equal
to the JAX package's digest of the same checkpoint at that rung; the same
typed refusals from both services; a checkpoint carrying canary goldens
written by either package restores (manifest verified) in the other and
passes the other's canary at prepare.

The cross-package goldens finding: at this configuration on the CPU the
canary digests of all three operations agree across the packages for
either model (the uint8 images of the canary inputs are equal, not just
within 1), so a JAX-published checkpoint passes the port's strict canary
here. Elsewhere (other widths, the card, whose float sums differ from XLA
on the CPU) only the encode digests are expected to agree; the canary is
not loosened for that: a port service publishes its own goldens
(`prepare_swap` -> `canary_goldens(staged=True)` -> `abort_swap` ->
re-save).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from dsin_tpu.coding import loader as jax_loader
from dsin_tpu.coding import precision as jax_precision
from dsin_tpu.serve import CompressionService as JaxService
from dsin_tpu.serve import ServiceConfig as JaxConfig
from dsin_tpu.train import checkpoint as jax_ckpt
from dsin_tpu.train.step import TrainState
from dsin_tpu_torch import bridge
from dsin_tpu_torch.config import parse_config
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.serve import CompressionService, ServiceConfig
from dsin_tpu_torch.train import checkpoint as port_ckpt
from test_train_step import tiny_ae_cfg, tiny_pc_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BUCKET = (16, 24)


def _jax_save(path, params, stats, extra):
    jax_ckpt.save_checkpoint(path, TrainState(
        params=params, batch_stats=stats, opt_state=(), step=jnp.int32(0)),
        manifest_extra=extra)
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("lifecycle")
    ae = tiny_ae_cfg(crop_size=BUCKET, batch_size=1)
    pc = tiny_pc_cfg()
    ae_p, pc_p = str(root / "ae"), str(root / "pc")
    for path, cfg in ((ae_p, ae), (pc_p, pc)):
        with open(path, "w") as f:
            f.write(str(cfg))
    extra = {"pc_config_sha256": jax_ckpt.config_sha256(pc),
             "buckets": [list(BUCKET)]}
    trees = {}
    for name, seed in (("a", 3), ("b", 4)):
        model = build_model(parse_config(str(ae)).replace(AE_only=False),
                            parse_config(str(pc)), device="cpu", seed=seed)
        trees[name] = bridge.jax_from_state_dict(model.state_dict())
        _jax_save(str(root / name), *trees[name], {**extra, "seed": seed})
    common = dict(ae_config=ae_p, pc_config=pc_p, ckpt=str(root / "a"),
                  buckets=(BUCKET,), max_batch=2, max_wait_ms=2.0,
                  enable_si=True, entropy_workers=1)
    jsvc = JaxService(JaxConfig(persistent_cache=False, **common)).start()
    jsvc.warmup()
    psvc = CompressionService(ServiceConfig(device="cpu", **common)).start()
    psvc.warmup()
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in ((16, 24), (14, 20), (9, 13))]
    yield dict(root=root, common=common, extra=extra, trees=trees,
               jsvc=jsvc, psvc=psvc, imgs=imgs)
    jsvc.drain()
    assert psvc.drain()


def _streams(svc, imgs):
    return [svc.encode(img).stream for img in imgs]


def test_streams_byte_equal_across_swap_and_rollback(world):
    jsvc, psvc, imgs = world["jsvc"], world["psvc"], world["imgs"]
    b = str(world["root"] / "b")
    before = _streams(jsvc, imgs)
    assert _streams(psvc, imgs) == before
    jinfo, pinfo = jsvc.swap_model(b), psvc.swap_model(b)
    try:
        assert pinfo["digest"] == jinfo["digest"]
        assert psvc.model_digest == jsvc.model_digest != \
            psvc.health()["model"]["prev_digest"]
        after = _streams(jsvc, imgs)
        assert _streams(psvc, imgs) == after != before
        assert psvc.canary_goldens() == jsvc.canary_goldens()
    finally:
        jsvc.rollback()
        psvc.rollback()
    assert psvc.model_digest == jsvc.model_digest
    assert _streams(jsvc, imgs) == _streams(psvc, imgs) == before


@pytest.mark.parametrize("rung", ["fp32", "bf16", "int8"])
def test_swapped_digest_equals_jax_at_every_rung(world, rung):
    """A swap re-casts the incoming checkpoint onto the service's rung
    after its manifest verified: the port's swapped digest equals the JAX
    package's digest of that checkpoint restored, verified and cast to the
    rung (its `load_swap_state`, `cast_params`, `params_digest`: the JAX
    service's prepare_swap)."""
    b = str(world["root"] / "b")
    model, state = jax_loader.load_model_state(
        world["common"]["ae_config"], world["common"]["pc_config"], None,
        BUCKET, need_sinet=True, seed=0)
    new_state, _ = jax_loader.load_swap_state(
        b, state, pc_config=model.pc_config, buckets=[BUCKET],
        need_sinet=True)
    if rung != "fp32":
        new_state = new_state.replace(params=jax_precision.PrecisionPolicy(
            rung).cast_params(new_state.params))
    want = jax_loader.params_digest((new_state.params,
                                     new_state.batch_stats), rung=rung)
    svc = CompressionService(ServiceConfig(
        device="cpu", precision=rung, **world["common"])).start()
    try:
        svc.warmup()
        assert svc.swap_model(b)["digest"] == want == svc.model_digest
    finally:
        assert svc.drain()


def _tampered(world, name, **changes):
    dst = str(world["root"] / name)
    _jax_save(dst, *world["trees"]["b"], {**world["extra"], "seed": 4})
    path = os.path.join(dst, jax_ckpt.MANIFEST_NAME)
    if changes.pop("remove", False):
        os.remove(path)
        return dst
    with open(path) as f:
        manifest = json.load(f)
    manifest.update(changes)
    with open(path, "w") as f:
        json.dump(manifest, f)
    return dst


REFUSALS = ["wrong_pc_hash", "wrong_ladder", "no_manifest",
            "double_prepare", "no_prev", "wrong_current"]


@pytest.mark.parametrize("case", REFUSALS)
def test_same_typed_refusals_as_jax(world, case):
    """Each refusal from both services: the same exception class name and
    the same message stem, and both still serving their model."""
    b = str(world["root"] / "b")
    if case == "wrong_pc_hash":
        ckpt = _tampered(world, case, pc_config_sha256="0" * 16)
    elif case == "wrong_ladder":
        ckpt = _tampered(world, case, buckets=[[64, 64]])
    elif case == "no_manifest":
        ckpt = _tampered(world, case, remove=True)
    got = {}
    for tag, svc in (("jax", world["jsvc"]), ("port", world["psvc"])):
        digest = svc.model_digest
        try:
            if case in ("wrong_pc_hash", "wrong_ladder", "no_manifest"):
                svc.swap_model(ckpt)
            elif case == "double_prepare":
                svc.prepare_swap(b)
                try:
                    svc.prepare_swap(b)
                finally:
                    svc.abort_swap()
            elif case == "no_prev":
                fresh = type(svc)(type(svc.config)(**{
                    **{k: getattr(svc.config, k) for k in (
                        "ae_config", "pc_config", "buckets", "max_batch")},
                    **({"device": "cpu"} if tag == "port" else
                       {"persistent_cache": False})})).start()
                try:
                    fresh.rollback()
                finally:
                    fresh.drain()
            else:
                info = svc.swap_model(b)
                try:
                    svc.rollback(expect_current="not-the-digest")
                finally:
                    svc.rollback(expect_current=info["digest"])
            got[tag] = None
        except Exception as e:  # noqa: BLE001 — compared below
            got[tag] = (type(e).__name__, str(e).split(" ")[:3])
        assert svc.model_digest == digest
        assert svc.health()["model"]["swap_state"] == 0
    assert got["port"] is not None and got["port"] == got["jax"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_goldens_checkpoint_restores_in_the_other_package(world, writer):
    """A checkpoint whose manifest carries canary goldens, written by one
    package (goldens from that package's service), restores in the other:
    its manifest verifies, and the other package's service passes its
    canary at prepare and commits it."""
    src, dst_svc = ((world["jsvc"], world["psvc"]) if writer == "jax"
                    else (world["psvc"], world["jsvc"]))
    b = str(world["root"] / "b")
    src.prepare_swap(b)
    goldens = src.canary_goldens(staged=True)
    src.abort_swap()
    params, stats = world["trees"]["b"]
    path = str(world["root"] / f"published_{writer}")
    extra = {**world["extra"], "seed": 4, "canary": goldens}
    if writer == "jax":
        _jax_save(path, params, stats, extra)
    else:
        port_ckpt.save_checkpoint(path, port_ckpt.ModelState(params, stats),
                                  manifest_extra=extra)
    info = dst_svc.swap_model(path)
    try:
        assert info["canary"]["status"] == "passed"
        assert dst_svc.model_digest == info["digest"]
    finally:
        dst_svc.rollback()


def test_canary_goldens_agree_across_packages(world):
    """The finding pinned: for the canary inputs at this configuration
    every op's digest agrees across the packages, for the served model and
    the staged one."""
    jsvc, psvc = world["jsvc"], world["psvc"]
    assert psvc.canary_goldens() == jsvc.canary_goldens()
    b = str(world["root"] / "b")
    jsvc.prepare_swap(b)
    psvc.prepare_swap(b)
    try:
        assert psvc.canary_goldens(staged=True) == \
            jsvc.canary_goldens(staged=True)
    finally:
        jsvc.abort_swap()
        psvc.abort_swap()
