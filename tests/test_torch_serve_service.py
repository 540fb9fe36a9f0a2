"""The port's CompressionService against the JAX package's, on the CPU.

One module-scoped JAX `CompressionService` (the tiny configuration of
tests/test_train_step.py, bucket (16, 24), `enable_si`, quality off) serves
weights that the JAX package's `save_checkpoint` wrote; the port's service
loads that checkpoint (`ckpt`) on `device="cpu"`.

Bounds: encode streams byte-equal (the symbols are asserted first to lie
more than 1e-4 from every center midpoint, so float noise cannot flip
one); `decode` and `decode_si` images within 1 on uint8 on at most 1% of
the pixels: both services cast float images to uint8 by truncation, and
the two packages' float32 nets agree to about 1e-5, which moves a value
across an integer now and then (the SI search's top-two margins are
asserted above 1e-4 first, so no patch match flips). Typed errors, the
worker restart, drain and the refusals are exact.
"""

import time
from urllib.request import urlopen

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsin_tpu.coding import loader as jax_loader
from dsin_tpu.serve import CompressionService as JaxService
from dsin_tpu.serve import ServiceConfig as JaxConfig
from dsin_tpu.train import checkpoint as jax_ckpt
from dsin_tpu.train import optim as jax_optim
from dsin_tpu.train.step import TrainState
from dsin_tpu_torch import bridge
from dsin_tpu_torch.coding import loader as port_loader
from dsin_tpu_torch.config import parse_config
from dsin_tpu_torch.data.synthetic import make_stereo_pair
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.models.quantizer import centers_lookup
from dsin_tpu_torch.ops import sifinder as sf
from dsin_tpu_torch.serve import (CompressionService, IntegrityError,
                                  NoBucketFits, ServiceConfig,
                                  ServiceDraining, SessionExpired)
from dsin_tpu_torch.serve.service import frame_stream, parse_stream
from dsin_tpu_torch.utils import faults
from test_train_step import tiny_ae_cfg, tiny_pc_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BUCKET = (16, 24)
SHAPES = [(16, 24), (14, 20), (9, 13)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_parity")
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
    common = dict(ae_config=ae_p, pc_config=pc_p, ckpt=ckpt,
                  buckets=(BUCKET,), max_batch=2, max_wait_ms=2.0,
                  enable_si=True)
    jsvc = JaxService(JaxConfig(quality_enabled=False, entropy_workers=1,
                                persistent_cache=False, **common)).start()
    jsvc.warmup()
    rng = np.random.default_rng(11)
    left, right = make_stereo_pair(rng, BUCKET[0], BUCKET[1] + 8)
    images = [left[:h, :w] for h, w in SHAPES]
    yield dict(common=common, jsvc=jsvc, side=right[:, 8:].copy(),
               images=images)
    jsvc.drain()


def _service(world, **over):
    kw = dict(world["common"], device="cpu")
    kw.update(over)
    svc = CompressionService(ServiceConfig(**kw)).start()
    svc.warmup()
    return svc


@pytest.fixture(scope="module")
def port(world):
    svc = _service(world, entropy_workers=2, metrics_port=0)
    yield svc
    svc.drain()


@pytest.fixture(scope="module")
def streams(world, port):
    """Each image through both services, after checking that no latent
    lies within 1e-4 of a center midpoint."""
    model = port.server.model
    centers = np.sort(model.centers.detach().numpy())
    mids = (centers[1:] + centers[:-1]) / 2
    for img in world["images"]:
        x = np.pad(img.astype(np.float32),
                   ((0, BUCKET[0] - img.shape[0]),
                    (0, BUCKET[1] - img.shape[1]), (0, 0)), mode="edge")
        with torch.no_grad():
            z = model.encode(torch.from_numpy(x[None])).z.numpy()
        assert np.abs(z[..., None] - mids).min() > 1e-4
    futs = [port.submit_encode(img) for img in world["images"]]
    got = [f.result(60) for f in futs]
    want = [world["jsvc"].encode(img) for img in world["images"]]
    return got, want


def _close_uint8(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.01


def test_encode_streams_byte_equal_to_jax(streams):
    got, want = streams
    for g, w in zip(got, want):
        assert g.stream == w.stream
        assert (g.shape, g.bucket, g.payload_bytes, g.bpp) == \
            (w.shape, w.bucket, w.payload_bytes, w.bpp)


def test_model_digest_equals_jax(world, port):
    assert port.model_digest == world["jsvc"].model_digest
    assert port.health()["model"]["digest"] == port.model_digest


@pytest.mark.parametrize("rung", ["fp32", "bf16", "int8"])
def test_served_digest_equals_jax_at_every_rung(world, rung):
    """The digest of the model a service serves at each ladder rung, from
    the world's checkpoint: the port's `served_digest` equals the JAX
    package's `params_digest` of its `load_model_state` (computed here, not
    pinned). The bf16 and int8 rungs hash their bfloat16 leaves as
    bfloat16; exact."""
    c = world["common"]
    _, state = jax_loader.load_model_state(
        c["ae_config"], c["pc_config"], c["ckpt"], BUCKET, need_sinet=True,
        precision=rung)
    want = jax_loader.params_digest((state.params, state.batch_stats),
                                    rung=rung)
    model = port_loader.load_model_state(
        c["ae_config"], c["pc_config"], c["ckpt"], need_sinet=True,
        device="cpu", precision=rung)
    assert port_loader.served_digest(model, rung) == want


def test_bf16_service_reports_the_jax_digest(world):
    """The service's `model_digest` is the served digest: at bf16, the JAX
    package's digest of the same checkpoint at that rung."""
    c = world["common"]
    _, state = jax_loader.load_model_state(
        c["ae_config"], c["pc_config"], c["ckpt"], BUCKET, need_sinet=True,
        precision="bf16")
    svc = _service(world, precision="bf16")
    try:
        assert svc.model_digest == jax_loader.params_digest(
            (state.params, state.batch_stats), rung="bf16")
    finally:
        svc.drain()


def test_decode_within_one_of_jax(world, port, streams):
    for res in streams[0]:
        _close_uint8(port.decode(res.stream), world["jsvc"].decode(res.stream))


def test_decode_si_within_one_of_jax(world, port, streams):
    sid = port.open_session(world["side"])
    jsid = world["jsvc"].open_session(world["side"])
    prep = port._sessions.get(sid).prep
    model = port.server.model
    for res in streams[0]:
        vol = port.codec.decode(parse_stream(res.stream)[0])
        sym = torch.from_numpy(np.transpose(vol, (1, 2, 0))[None])
        with torch.no_grad():
            x_dec = model.decode(centers_lookup(model.centers, sym))
        r = sf.search_single(x_dec[0], None, None, None, 8, 12, prep=prep)
        top2 = torch.topk(r.score_map.reshape(-1, r.score_map.shape[-1]), 2,
                          dim=0).values
        assert float((top2[0] - top2[1]).min()) > 1e-4
    futs = [port.submit_decode_si(res.stream, sid) for res in streams[0]]
    for res, fut in zip(streams[0], futs):
        got = fut.result(60)
        _close_uint8(got, world["jsvc"].decode_si(res.stream, jsid))
        assert not np.array_equal(got, port.decode(res.stream))
    assert port.close_session(sid) and not port.close_session(sid)


def test_serialized_and_pipelined_bytes_identical(world, port, streams):
    """entropy_workers 0 (inline) and 2 (the pool) give the same streams
    and the same images."""
    svc = _service(world, entropy_workers=0)
    try:
        for img, res in zip(world["images"], streams[0]):
            assert svc.encode(img).stream == res.stream
            np.testing.assert_array_equal(svc.decode(res.stream),
                                          port.decode(res.stream))
    finally:
        assert svc.drain()


def test_integrity_error_stays_on_its_lane(port, streams):
    good = streams[0][0].stream
    flipped = bytearray(good)
    flipped[-1] ^= 0x01
    with pytest.raises(IntegrityError):
        port.submit_decode(bytes(flipped))          # at the door
    want = port.decode(good)
    plan = faults.FaultPlan([faults.FaultSpec("serve.rans", "corrupt",
                                              after=1, times=1)])
    with faults.installed(plan):
        futs = [port.submit_decode(good) for _ in range(2)]
        errors = [f.exception(60) for f in futs]
    assert plan.activations["serve.rans"] == 1
    assert sum(isinstance(e, IntegrityError) for e in errors) == 1
    for f, e in zip(futs, errors):
        if e is None:
            np.testing.assert_array_equal(f.result(0), want)


def test_typed_refusals_at_the_door(port, streams):
    with pytest.raises(SessionExpired):
        port.submit_decode_si(streams[0][0].stream, "sess-unknown")
    with pytest.raises(NoBucketFits):
        port.submit_encode(np.zeros((17, 24, 3), np.uint8))
    other = frame_stream(parse_stream(streams[0][0].stream)[0], (8, 8),
                         (32, 48))
    with pytest.raises(NoBucketFits):
        port.submit_decode(other)


def test_metrics_and_health_endpoints(port, streams):
    base = f"http://127.0.0.1:{port.metrics_port}"
    with urlopen(f"{base}/healthz", timeout=10) as r:
        assert r.status == 200 and b'"ok"' in r.read()
    with urlopen(f"{base}/metrics", timeout=10) as r:
        text = r.read().decode()
    for name in ("serve_completed_total", "serve_device_ms_count",
                 "serve_entropy_ms_count", "serve_overlap_ratio"):
        assert name in text


def test_crashed_worker_restarts_and_serves(world, streams):
    svc = _service(world, entropy_workers=1, restart_backoff_s=0.01)
    try:
        plan = faults.FaultPlan([faults.FaultSpec(
            "serve.worker.batch", "crash", times=1)])
        with faults.installed(plan):
            with pytest.raises(faults.InjectedCrash):
                svc.encode(world["images"][0], timeout=60)
        deadline = time.monotonic() + 30
        while svc.metrics.counter("serve_worker_restarts").value < 1:
            assert time.monotonic() < deadline, "no restart"
            time.sleep(0.01)
        assert svc.encode(world["images"][0]).stream == streams[0][0].stream
        assert svc.health()["worker_restarts"] >= 1
    finally:
        assert svc.drain()


def test_drain_leaves_no_hung_future(world, streams):
    svc = _service(world, entropy_workers=1)
    futs = [svc.submit_encode(img) for img in world["images"] * 3]
    futs += [svc.submit_decode(res.stream) for res in streams[0]]
    assert svc.drain(timeout=60)
    for f in futs:
        assert f.done()
        e = f.exception(0)
        assert e is None or isinstance(e, ServiceDraining)
    with pytest.raises(ServiceDraining):
        svc.submit_encode(world["images"][0])


@pytest.mark.parametrize("over,item", [
    ({"devices": 2}, "11c"),
    ({"placement_weights": {BUCKET: 1.0}}, "11c"),
    ({"rebalance_check_every_s": 1.0}, "11c")])
def test_refused_configurations_name_their_item(world, over, item):
    kw = dict(world["common"], device="cpu")
    kw.update(over)
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 item {item} "):
        CompressionService(ServiceConfig(**kw))


def test_priority_classes_configuration_now_serves(world, streams):
    """The configuration that named item 11d is no longer refused: an empty
    class tuple meets the batcher's own ValueError, as in the JAX service,
    and the shipped two classes serve the same streams as no classes."""
    from dsin_tpu_torch.serve import BULK, default_priority_classes
    kw = dict(world["common"], device="cpu")
    with pytest.raises(ValueError, match="at least one priority class"):
        CompressionService(ServiceConfig(priority_classes=(), **kw))
    with pytest.raises(ValueError, match="at least one priority class"):
        JaxService(JaxConfig(priority_classes=(), persistent_cache=False,
                             **world["common"]))
    svc = _service(world, priority_classes=default_priority_classes(8))
    try:
        got = [svc.encode(img, priority=BULK).stream
               for img in world["images"]]
        assert got == [r.stream for r in streams[0]]
        assert svc.metrics.counter(f"serve_admitted_{BULK}").value == 3
    finally:
        assert svc.drain()


@pytest.mark.parametrize("over,match", [
    ({"entropy_backend": "process", "entropy_workers": 0},
     "entropy_workers > 0"),
    ({"entropy_backend": "fiber"}, "entropy_backend"),
    ({"transport": "carrier-pigeon"}, "transport"),
    ({"entropy_backend": "process", "entropy_proc_timeout_s": 0.0},
     "entropy_proc_timeout_s")])
def test_backend_configurations_are_validated_typed(world, over, match):
    """The JAX service's validation of the entropy-backend knobs, typed
    ValueError at start() before the model build."""
    kw = dict(world["common"], device="cpu")
    kw.update(over)
    with pytest.raises(ValueError, match=match):
        CompressionService(ServiceConfig(**kw)).start()


@pytest.mark.parametrize("over,match", [
    ({"canary_every_s": 0.0}, "canary_every_s"),
    ({"canary_every_s": -1.0}, "canary_every_s"),
    ({"canary_timeout_s": 0.0}, "canary_timeout_s"),
    ({"canary_every_s": 1.0, "session_max": 1}, "session_max"),
    ({"quality_gap_sample_rate": 1.5}, "gap_sample_rate"),
    ({"quality_gap_sample_rate": -0.1}, "gap_sample_rate"),
    ({"si_alarm_frac": 0.0}, "si_alarm_frac"),
    ({"si_alarm_min_samples": 0}, "si_alarm_min_samples"),
    ({"rollback_watchdog_window_s": 0.0}, "window_s"),
    ({"rollback_watchdog_window_s": 1.0, "rollback_watchdog_threshold": 0.0},
     "threshold"),
    ({"rollback_watchdog_window_s": 1.0,
      "rollback_watchdog_min_requests": 0}, "min_requests")])
def test_lifecycle_configurations_are_validated_typed(world, over, match):
    """The quality, canary and watchdog knobs, validated as the JAX service
    validates them: a typed ValueError before the model build."""
    kw = dict(world["common"], device="cpu")
    kw.update(over)
    with pytest.raises(ValueError, match=match):
        CompressionService(ServiceConfig(**kw)).start()


@pytest.mark.parametrize("method,args,item", [
    ("rebalance_placement", (), "11c")])
def test_refused_operations_name_their_item(port, method, args, item):
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 item {item} "):
        getattr(port, method)(*args)


def test_no_native_build_after_warmup(port, streams):
    from dsin_tpu_torch import native_build
    before = native_build.build_count()
    port.encode(np.zeros((5, 7, 3), np.uint8))
    assert native_build.build_count() == before
