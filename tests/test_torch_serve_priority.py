"""Priority classes and admission in the port's CompressionService, against
the JAX package's service, on the CPU.

Both services serve the tiny configuration of tests/test_train_step.py at
bucket (16, 24) from one checkpoint the JAX package's `save_checkpoint`
wrote (the weights of the port's seeded model), with
`default_priority_classes`. With the worker held inside its first batch,
one scripted schedule of submits drives both doors: the decisions (served,
shed at the admission gate, shed at the queue, shed later as a victim), the
exception types and the per-class counters must be equal, and bulk must be
shed first, both at the door and as a victim. Streams submitted with a
class are byte-equal to the JAX service's (the images' latents lie more
than 1e-4 from every center midpoint, asserted in
tests/test_torch_serve_service.py for the same images). Exact.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from dsin_tpu.serve import CompressionService as JaxService
from dsin_tpu.serve import ServiceConfig as JaxConfig
from dsin_tpu.serve import batcher as jax_batcher
from dsin_tpu.train import checkpoint as jax_ckpt
from dsin_tpu.train import optim as jax_optim
from dsin_tpu.train.step import TrainState
from dsin_tpu_torch import bridge
from dsin_tpu_torch.config import parse_config
from dsin_tpu_torch.data.synthetic import make_stereo_pair
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.serve import (BULK, INTERACTIVE, CompressionService,
                                  ServiceConfig, default_priority_classes)
from test_train_step import tiny_ae_cfg, tiny_pc_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BUCKET = (16, 24)
SHAPES = [(16, 24), (14, 20), (9, 13)]
#: admission caps and queue bound of the held-worker schedule: bulk's
#: gate is below its queue bound, so the 4th bulk sheds at the gate
LIMITS = {INTERACTIVE: 8, BULK: 3}
QUEUE = 4
#: the schedule: the first interactive request is popped and held by the
#: worker; then 4 bulk (the 4th shed at the gate), 3 interactive (the 2nd
#: and 3rd take the two newest bulk slots: victims), 1 bulk (no lower
#: class to shed: refused at the queue)
SCHEDULE = [INTERACTIVE, "hold", BULK, BULK, BULK, BULK, INTERACTIVE,
            INTERACTIVE, INTERACTIVE, BULK]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_priority")
    ae = tiny_ae_cfg(crop_size=BUCKET, batch_size=1)
    pc = tiny_pc_cfg()
    ae_p, pc_p = str(root / "ae"), str(root / "pc")
    for path, cfg in ((ae_p, ae), (pc_p, pc)):
        with open(path, "w") as f:
            f.write(str(cfg))
    source = build_model(parse_config(str(ae)).replace(AE_only=False),
                         parse_config(str(pc)), device="cpu", seed=3)
    params, stats = bridge.jax_from_state_dict(source.state_dict())
    tx = jax_optim.build_optimizer(params, ae.replace(AE_only=False), pc,
                                   num_training_imgs=4)
    ckpt = str(root / "ckpt")
    jax_ckpt.save_checkpoint(ckpt, TrainState(
        params=params, batch_stats=stats, opt_state=tx.init(params),
        step=jnp.int32(0)), manifest_extra={
            "pc_config_sha256": jax_ckpt.config_sha256(pc), "seed": 3})
    rng = np.random.default_rng(11)
    left, _ = make_stereo_pair(rng, BUCKET[0], BUCKET[1] + 8)
    common = dict(ae_config=ae_p, pc_config=pc_p, ckpt=ckpt,
                  buckets=(BUCKET,), max_batch=1, max_wait_ms=0.0,
                  max_queue=QUEUE, admission_limits=LIMITS,
                  entropy_workers=1)
    jsvc = JaxService(JaxConfig(
        quality_enabled=False, persistent_cache=False,
        priority_classes=jax_batcher.default_priority_classes(QUEUE),
        **common)).start()
    jsvc.warmup()
    port = CompressionService(ServiceConfig(
        device="cpu", priority_classes=default_priority_classes(QUEUE),
        **common)).start()
    port.warmup()
    yield dict(jsvc=jsvc, port=port,
               images=[left[:h, :w] for h, w in SHAPES])
    jsvc.drain()
    port.drain()


def _held_schedule(svc, img):
    """SCHEDULE through `svc` with its worker held inside the first batch;
    -> (per-submit outcome, the per-class counters)."""
    entered, release = threading.Event(), threading.Event()
    first = []

    def hook(batch):
        if not first:
            first.append(batch)
            entered.set()
            release.wait(30)

    svc._batch_hook = hook
    outcomes, futures = [], []
    try:
        for step in SCHEDULE:
            if step == "hold":
                assert entered.wait(30)
                continue
            try:
                futures.append((len(outcomes),
                                svc.submit_encode(img, priority=step)))
                outcomes.append([step, "queued"])
            except RuntimeError as e:    # each package's own ServeError
                outcomes.append([step, "door", type(e).__name__, e.priority,
                                 e.depth])
    finally:
        release.set()
    for i, fut in futures:
        exc = fut.exception(timeout=60)
        outcomes[i].append("served" if exc is None else
                           (type(exc).__name__, exc.priority))
    svc._batch_hook = None
    counters = svc.metrics.snapshot()["counters"]
    keys = [f"serve_{what}_{cls}" for what in
            ("admitted", "shed_admission", "shed")
            for cls in (INTERACTIVE, BULK)]
    return outcomes, {k: counters.get(k, 0) for k in keys}


def test_held_worker_shed_order_equals_jax(world):
    img = world["images"][0]
    want = _held_schedule(world["jsvc"], img)
    got = _held_schedule(world["port"], img)
    assert got == want
    outcomes, counters = got
    # bulk sheds first and only bulk: at the gate, as victims, at the queue
    shed = [o for o in outcomes if o[-1] != "served"]
    assert shed and all(o[0] == BULK for o in shed)
    assert all(o[-1] == "served" for o in outcomes if o[0] == INTERACTIVE)
    assert counters[f"serve_shed_admission_{BULK}"] == 1
    assert counters[f"serve_shed_{BULK}"] == 2
    assert counters[f"serve_shed_{INTERACTIVE}"] == 0
    assert counters[f"serve_admitted_{INTERACTIVE}"] == 4


def test_gate_releases_every_slot(world):
    """After the schedule resolved, the gate holds nothing outstanding and
    the per-class latency histogram holds each served request."""
    port = world["port"]
    _held_schedule(port, world["images"][1])
    assert port._admission.outstanding() == {INTERACTIVE: 0, BULK: 0}
    hists = port.metrics.snapshot()["histograms"]
    assert hists[f"serve_latency_ms_{INTERACTIVE}"]["count"] >= 4


@pytest.mark.parametrize("cls", [INTERACTIVE, BULK, None])
def test_class_streams_byte_equal_to_jax(world, cls):
    for img in world["images"]:
        got = world["port"].encode(img, priority=cls)
        want = world["jsvc"].encode(img, priority=cls)
        assert got.stream == want.stream
        assert got.bpp == want.bpp


def test_unknown_class_refused_typed_like_jax(world):
    from dsin_tpu_torch.serve.batcher import UnknownPriorityClass
    with pytest.raises(UnknownPriorityClass):
        world["port"].submit_encode(world["images"][0], priority="vip")
    with pytest.raises(jax_batcher.UnknownPriorityClass):
        world["jsvc"].submit_encode(world["images"][0], priority="vip")


def test_front_door_trace_context_is_honoured(world):
    """A context passed in replaces the one the service would mint."""
    from dsin_tpu_torch.serve.trace import TraceContext
    ctx = TraceContext("door-1", True)
    fut = world["port"].submit_encode(world["images"][2], priority=BULK,
                                      trace=ctx)
    fut.result(60)
    assert fut.trace == ctx


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_express_lane_starts_the_first_class_past_a_bulk_batch(world, depth):
    """The port's worker (not the JAX one) starts an interactive batch at
    once while a bulk batch's entropy task is held: with depth 1 the
    pipeline is full, with depth 2 and 4 the queue is empty and the worker
    is finishing the bulk batch. The interactive request resolves; the bulk
    one resolves once released. Streams are the unheld ones."""
    from dsin_tpu_torch.serve import ServiceConfig as PortConfig
    port = world["port"]
    cfg = PortConfig(**{**port.config.__dict__, "pipeline_depth": depth,
                        "entropy_workers": 2, "admission_limits": None})
    svc = CompressionService(cfg).start()
    try:
        svc.warmup()
        img = world["images"][0]
        want = svc.encode(img, priority=BULK).stream
        release = threading.Event()
        task = svc._entropy_batch_task

        def held(rec):
            if rec.batch[0].priority == BULK:
                release.wait(30)
            return task(rec)

        svc._entropy_batch_task = held
        bulk = svc.submit_encode(img, priority=BULK)
        time.sleep(0.2)                 # the bulk batch fills the pipeline
        fast = svc.submit_encode(img, priority=INTERACTIVE)
        assert fast.result(30).stream == want
        assert not bulk.done()
        release.set()
        assert bulk.result(30).stream == want
    finally:
        release.set()
        svc.drain()
