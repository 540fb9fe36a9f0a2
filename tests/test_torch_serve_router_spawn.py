"""The port's FrontDoorRouter over REAL spawned replica processes, on the
CPU (`device="cpu"`), against the JAX package's single-process service.

Both serve the tiny configuration of tests/test_train_step.py from one
checkpoint the JAX package's `save_checkpoint` wrote. Two spawned port
replicas answer encode with streams equal to each other's and byte-equal
to the JAX service's (each image twice in one class: round-robin puts one
copy on each replica); a fleet `swap_model` to a second checkpoint (the
port's own, with its manifest) converges on one new digest across the
pair, and `rollback()` restores the old streams. One router on
`transport="shm"` gives the bytes of an in-process port service, sends
lanes both ways, and leaves no `dsintorch-*` segment behind. Children
run at one torch thread (`OMP_NUM_THREADS=1` in their environment).
Exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from dsin_tpu.serve import CompressionService as JaxService
from dsin_tpu.serve import ServiceConfig as JaxConfig
from dsin_tpu.train import checkpoint as jax_ckpt
from dsin_tpu.train import optim as jax_optim
from dsin_tpu.train.step import TrainState
from dsin_tpu_torch import bridge
from dsin_tpu_torch.config import parse_config
from dsin_tpu_torch.data.synthetic import make_stereo_pair
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.serve import (BULK, CompressionService, FrontDoorRouter,
                                  ServiceConfig, default_priority_classes)
from dsin_tpu_torch.train import checkpoint as ckpt_lib
from test_train_step import tiny_ae_cfg, tiny_pc_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BUCKET = (16, 24)
#: a bucket whose uint8 images (18,432 B) exceed the lanes' inline bound
LANE_BUCKET = (64, 96)


def _segments():
    return {n for n in os.listdir("/dev/shm") if n.startswith("dsintorch-")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("router_spawn")
    ae = tiny_ae_cfg(crop_size=BUCKET, batch_size=1)
    pc = tiny_pc_cfg()
    ae_p, pc_p = str(root / "ae"), str(root / "pc")
    for path, cfg in ((ae_p, ae), (pc_p, pc)):
        with open(path, "w") as f:
            f.write(str(cfg))
    ae_c = parse_config(str(ae))
    pc_c = parse_config(str(pc))
    source = build_model(ae_c.replace(AE_only=False), pc_c, device="cpu",
                         seed=3)
    params, stats = bridge.jax_from_state_dict(source.state_dict())
    tx = jax_optim.build_optimizer(params, ae.replace(AE_only=False), pc,
                                   num_training_imgs=4)
    ckpt = str(root / "ckpt")
    jax_ckpt.save_checkpoint(ckpt, TrainState(
        params=params, batch_stats=stats, opt_state=tx.init(params),
        step=jnp.int32(0)), manifest_extra={
            "pc_config_sha256": jax_ckpt.config_sha256(pc), "seed": 3})
    # checkpoint B, the port's own, with the manifest a swap verifies
    ckpt_b = str(root / "ckpt_b")
    ckpt_lib.save_checkpoint(
        ckpt_b, ckpt_lib.state_from_model(build_model(
            ae_c.replace(AE_only=True), pc_c, device="cpu", seed=11)),
        manifest_extra={"pc_config_sha256": ckpt_lib.config_sha256(pc_c),
                        "seed": 11, "buckets": [list(BUCKET)]})
    rng = np.random.default_rng(11)
    left, _ = make_stereo_pair(rng, BUCKET[0], BUCKET[1] + 8)
    images = [left[:16, :24], left[:14, :20]]
    common = dict(ae_config=ae_p, pc_config=pc_p, ckpt=ckpt,
                  buckets=(BUCKET,), max_batch=2, max_wait_ms=2.0,
                  max_queue=16, entropy_workers=1)
    jsvc = JaxService(JaxConfig(quality_enabled=False,
                                persistent_cache=False, **common)).start()
    try:
        jsvc.warmup()
        jax_streams = [jsvc.encode(img).stream for img in images]
    finally:
        jsvc.drain()
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"     # the spawned children inherit it
    yield dict(common=common, ckpt_b=ckpt_b, images=images,
               jax_streams=jax_streams,
               lane_image=rng.integers(0, 255, (*LANE_BUCKET, 3),
                                       dtype=np.uint8))
    if before is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = before


def _config(world, **over):
    kw = dict(world["common"], device="cpu",
              priority_classes=default_priority_classes(16))
    kw.update(over)
    return ServiceConfig(**kw)


def test_spawned_replicas_equal_jax_and_swap_as_a_fleet(world):
    router = FrontDoorRouter(_config(world), replicas=2, poll_every_s=0.5,
                             start_timeout_s=300.0).start()
    try:
        infos = [rep.info for rep in router._replicas]
        assert [i["device"] for i in infos] == ["cpu", "cpu"]
        assert len({i["pid"] for i in infos}) == 2
        assert all(i["builds_at_ready"] == 0 for i in infos)
        streams = []
        for img, want in zip(world["images"], world["jax_streams"]):
            a = router.encode(img, timeout=120.0)          # replica 0
            b = router.encode(img, timeout=120.0)          # replica 1
            c = router.encode(img, priority=BULK, timeout=120.0)
            assert a.stream == b.stream == c.stream == want
            streams.append(a.stream)
        assert router.decode(streams[1], timeout=120.0).shape == (14, 20, 3)
        old = router.params_digest
        out = router.swap_model(world["ckpt_b"])
        assert out["digest"] != old and router.params_digest == out["digest"]
        assert sorted(out["prepare"]) == [0, 1]
        x = router.encode(world["images"][0], timeout=120.0)
        y = router.encode(world["images"][0], timeout=120.0)
        assert x.stream == y.stream != streams[0]
        assert x.model_digest == out["digest"]
        back = router.rollback()
        assert back["digest"] == old and back["replicas"] == [0, 1]
        assert [router.encode(world["images"][0], timeout=120.0).stream
                for _ in range(2)] == [streams[0]] * 2
        snap = router.metrics.snapshot()["counters"]
        assert snap["serve_router_routed_r0"] > 0
        assert snap["serve_router_routed_r1"] > 0
        assert snap["serve_router_swaps"] == 1
        assert snap["serve_router_rollbacks"] == 1
        per = router.aggregate.snapshot()["info"]["per_replica"]
        assert [per[k]["serve_native_builds"] for k in ("0", "1")] == [0, 0]
        assert router.health()["status"] == "ok"
    finally:
        router.drain(timeout_s=60)


def test_shm_transport_gives_the_bytes_and_leaks_no_segment(world):
    cfg = _config(world, buckets=(BUCKET, LANE_BUCKET))
    images = [world["images"][0], world["lane_image"]]
    svc = CompressionService(cfg).start()
    try:
        svc.warmup()
        want = [svc.encode(img).stream for img in images]
    finally:
        svc.drain()
    router = FrontDoorRouter(cfg, replicas=1, transport="shm",
                             start_timeout_s=300.0).start()
    try:
        # the replica's two rings (other test files may hold segments of
        # their own meanwhile: the check names this router's)
        rings = {ring.name for ring in router._replicas[0].rings.values()}
        assert len(rings) == 2 and rings <= _segments()
        got = [router.encode(img, timeout=120.0).stream for img in images]
        decoded = router.decode(got[1], timeout=120.0)
        counters = router.metrics.snapshot()["counters"]
    finally:
        router.drain(timeout_s=60)
    assert got == want and got[0] == world["jax_streams"][0]
    assert decoded.shape == (*LANE_BUCKET, 3)
    assert counters.get("serve_shm_sends", 0) >= 1
    assert counters.get("serve_shm_integrity_errors", 0) == 0
    assert not rings & _segments()
