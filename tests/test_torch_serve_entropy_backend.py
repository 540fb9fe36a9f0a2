"""The port's process entropy backend and shm lanes against its thread
backend and the JAX service, on the CPU.

One JAX-written checkpoint of the tiny configuration of
tests/test_train_step.py (the setup of tests/test_torch_serve_service.py)
serves in a JAX `CompressionService` (thread backend, bucket (16, 24)) and
in three port services on `device="cpu"`, two entropy workers each: the
thread backend, and the process backend on `transport="pipe"` and on
`"shm"`. The port's services add a (128, 144) bucket, whose full batch of
4 symbol volumes is the smallest payload the lanes carry (a pickle under
`SMALL_INLINE_MAX` rides the pipe).

Bounds: streams byte-equal across the three port services and the JAX
service; port images bit-equal across the port's backends (the same device
code on the same symbols) and within 1 on uint8 of the JAX service's on at
most 1% of the pixels (tests/test_torch_serve_service.py says why); symbols
equal; the typed errors, rebuild counts and child probes exact. The hung
child is a 30 s sleep held to a 2 s bound passed to that one call, so
neither warmup nor a rebuilt pool's spawn meets the bound.
"""

import os
import pickle
import time

import jax.numpy as jnp
import numpy as np
import pytest

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
from dsin_tpu_torch.serve import (CompressionService, IntegrityError,
                                  ServiceConfig)
from dsin_tpu_torch.serve import service as service_lib
from dsin_tpu_torch.serve import shmlane
from dsin_tpu_torch.serve import trace as trace_lib
from dsin_tpu_torch.serve.service import frame_stream
from dsin_tpu_torch.utils import faults
from test_train_step import tiny_ae_cfg, tiny_pc_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BUCKET = (16, 24)
BIG = (128, 144)
SHAPES = [(16, 24), (14, 20), (9, 13), (16, 24)]


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.uninstall()
    yield
    faults.uninstall()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("entropy_backend")
    ae = tiny_ae_cfg(crop_size=BUCKET, batch_size=1)
    pc = tiny_pc_cfg()
    ae_p, pc_p = str(root / "ae"), str(root / "pc")
    for path, cfg in ((ae_p, ae), (pc_p, pc)):
        with open(path, "w") as f:
            f.write(str(cfg))
    source = build_model(parse_config(str(ae)).replace(AE_only=False),
                         parse_config(str(pc)), device="cpu", seed=5)
    params, stats = bridge.jax_from_state_dict(source.state_dict())
    tx = jax_optim.build_optimizer(params, ae.replace(AE_only=False), pc,
                                   num_training_imgs=4)
    ckpt = str(root / "ckpt")
    jax_ckpt.save_checkpoint(ckpt, TrainState(
        params=params, batch_stats=stats, opt_state=tx.init(params),
        step=jnp.int32(0)), manifest_extra={
            "pc_config_sha256": jax_ckpt.config_sha256(pc), "seed": 5})
    common = dict(ae_config=ae_p, pc_config=pc_p, ckpt=ckpt, max_batch=4,
                  max_wait_ms=50.0, enable_si=True)
    jsvc = JaxService(JaxConfig(quality_enabled=False, entropy_workers=1,
                                persistent_cache=False, buckets=(BUCKET,),
                                **common)).start()
    jsvc.warmup()
    rng = np.random.default_rng(12)
    left, right = make_stereo_pair(rng, BIG[0], BIG[1] + 8)
    yield dict(common=common, jsvc=jsvc,
               side=right[:BUCKET[0], 8:8 + BUCKET[1]].copy(),
               images=[left[:h, :w].copy() for h, w in SHAPES],
               big=[np.roll(left[:, :BIG[1]], 3 * k, axis=1).copy()
                    for k in range(4)])
    jsvc.drain()


def _service(world, **over):
    kw = dict(world["common"], device="cpu", buckets=(BUCKET, BIG),
              entropy_workers=2)
    kw.update(over)
    svc = CompressionService(ServiceConfig(**kw)).start()
    svc.warmup()
    return svc


@pytest.fixture(scope="module")
def thread_svc(world):
    svc = _service(world)
    yield svc
    svc.drain()


@pytest.fixture(scope="module")
def proc_pipe(world):
    svc = _service(world, entropy_backend="process", transport="pipe")
    yield svc
    if not svc.draining:
        svc.drain()


@pytest.fixture(scope="module")
def proc_shm(world):
    svc = _service(world, entropy_backend="process", transport="shm")
    yield svc
    if not svc.draining:
        svc.drain()


def _encode_all(svc, images):
    futs = [svc.submit_encode(img) for img in images]
    return [f.result(120) for f in futs]


def _decode_all(svc, streams, sid=None):
    futs = [svc.submit_decode(s) if sid is None else
            svc.submit_decode_si(s, sid) for s in streams]
    return [f.result(120) for f in futs]


def _close_uint8(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.01


@pytest.fixture(scope="module")
def reference(world, thread_svc):
    """The thread backend's and the JAX service's answers to the traffic."""
    enc = _encode_all(thread_svc, world["images"])
    streams = [r.stream for r in enc]
    sid = thread_svc.open_session(world["side"])
    jsid = world["jsvc"].open_session(world["side"])
    big = _encode_all(thread_svc, world["big"])
    return dict(
        streams=streams,
        jax_streams=[world["jsvc"].encode(img).stream
                     for img in world["images"]],
        decoded=_decode_all(thread_svc, streams),
        decoded_si=_decode_all(thread_svc, streams, sid),
        jax_decoded=[world["jsvc"].decode(s) for s in streams],
        jax_decoded_si=[world["jsvc"].decode_si(s, jsid) for s in streams],
        big_streams=[r.stream for r in big],
        big_decoded=_decode_all(thread_svc, [r.stream for r in big]))


# -- CodecSpec: picklable, bit-identical rebuild ------------------------------

def test_codec_spec_pickle_roundtrip_bit_identical(thread_svc):
    spec = port_loader.make_codec_spec(thread_svc.codec, rung="bf16")
    rebuilt = port_loader.codec_from_spec(pickle.loads(pickle.dumps(spec)))
    rng = np.random.default_rng(2)
    vols = [rng.integers(0, thread_svc.codec.num_centers, (4, 2, 3))
            for _ in range(3)]
    orig = thread_svc.codec.encode_batch(vols)
    assert rebuilt.encode_batch(vols) == orig
    for got, want in zip(rebuilt.decode_batch(orig), vols):
        np.testing.assert_array_equal(got, want)
    assert rebuilt.pad_value == thread_svc.codec.pad_value
    assert rebuilt.device.type == "cpu" and spec.rung == "bf16"


def test_codec_from_spec_streams_equal_the_jax_codec(world, thread_svc):
    """On the bridged weights, a spec-built port codec, the JAX service's
    codec and the JAX package's own spec rebuild give one stream."""
    jcodec = world["jsvc"].codec
    port = port_loader.codec_from_spec(
        port_loader.make_codec_spec(thread_svc.codec))
    jrebuilt = jax_loader.codec_from_spec(jax_loader.make_codec_spec(jcodec))
    rng = np.random.default_rng(3)
    vols = [rng.integers(0, jcodec.num_centers, shape)
            for shape in ((4, 2, 3), (4, 16, 18), (4, 1, 1))]
    want = jcodec.encode_batch(vols)
    assert port.encode_batch(vols) == want
    assert jrebuilt.encode_batch(vols) == want
    assert port.pad_value == pytest.approx(float(jcodec.pad_value), abs=0)


def test_worker_residence(world, proc_pipe):
    """Every child answered warmup's ping; each codes with ONE codec built
    at init (the same codec_id on a second ping), its schedules warmed for
    both buckets, torch and OpenBLAS pinned to one thread, no CUDA context,
    no jax, no native build."""
    pings = proc_pipe._proc_warm
    assert len({p["pid"] for p in pings}) == 2
    want = {(4, BUCKET[0] // 8, BUCKET[1] // 8), (4, BIG[0] // 8, BIG[1] // 8)}
    for p in pings:
        assert {tuple(s) for s in p["schedules"]} == want
        assert p["cuda_initialized"] is False
        assert p["native_builds"] == 0
        assert p["torch_threads"] == 1
        assert all(t == 1 for t in p["blas_threads"])
        assert p["init_s"] > 0 and p["init_wall"] <= time.time()
        assert "jax" not in p["top_modules"]
        assert "dsin_tpu" not in p["top_modules"]
    again = {p["pid"]: p["codec_id"]
             for p in proc_pipe._ping_children(proc_pipe._swap.current)}
    for p in pings:
        if p["pid"] in again:
            assert again[p["pid"]] == p["codec_id"]
    info = proc_pipe.metrics.snapshot()["info"]["serve_entropy_backend"]
    assert (info["backend"], info["transport"]) == ("process", "pipe")


def test_children_get_the_spec_by_path(proc_pipe):
    """The initializer's arguments name the pickled spec by path and stay
    small whatever the weights weigh (spawn's start-up pipe holds 64 KiB);
    the file's spec codes what the bundle's codec codes."""
    path, warm_shapes = proc_pipe._swap.current.proc_initargs
    assert isinstance(path, str) and len(pickle.dumps(
        (path, warm_shapes, None))) < 4096
    with open(path, "rb") as f:
        spec = pickle.load(f)
    rng = np.random.default_rng(4)
    vols = [rng.integers(0, proc_pipe.codec.num_centers, (4, 2, 3))
            for _ in range(2)]
    assert (port_loader.codec_from_spec(spec).encode_batch(vols)
            == proc_pipe.codec.encode_batch(vols))


def test_worker_without_initializer_fails_typed():
    saved = port_loader._worker_codec
    port_loader._worker_codec = None
    try:
        with pytest.raises(RuntimeError, match="init_worker_codec"):
            port_loader.worker_ping(settle_s=0.0)
        with pytest.raises(RuntimeError, match="init_worker_codec"):
            port_loader.worker_encode_batch([np.zeros((4, 2, 3), np.int32)])
    finally:
        port_loader._worker_codec = saved


# -- the process backend end to end -------------------------------------------

@pytest.mark.parametrize("transport", ["pipe", "shm"])
def test_streams_and_images_equal_thread_and_jax(world, reference,
                                                 transport, request):
    svc = request.getfixturevalue(f"proc_{transport}")
    streams = [r.stream for r in _encode_all(svc, world["images"])]
    assert streams == reference["streams"] == reference["jax_streams"]
    for got, want, jwant in zip(_decode_all(svc, streams),
                                reference["decoded"],
                                reference["jax_decoded"]):
        np.testing.assert_array_equal(got, want)
        _close_uint8(got, jwant)
    sid = svc.open_session(world["side"])
    for got, want, jwant in zip(_decode_all(svc, streams, sid),
                                reference["decoded_si"],
                                reference["jax_decoded_si"]):
        np.testing.assert_array_equal(got, want)
        _close_uint8(got, jwant)
    assert svc.metrics.counter("serve_entropy_proc_rebuilds").value == 0


def test_shm_lanes_carry_tasks_and_replies(world, reference, proc_shm):
    """Full batches at the big bucket: the encode task (4 volumes, counted
    by the parent's ring) and the decode reply (4 volumes, written by the
    child, counted at the parent's read) ride lanes, every lane is freed,
    nothing falls back, and the bytes and images equal the thread
    backend's."""
    before = proc_shm.metrics.snapshot()["counters"]
    enc = _encode_all(proc_shm, world["big"])
    assert [r.stream for r in enc] == reference["big_streams"]
    for got, want in zip(_decode_all(proc_shm, [r.stream for r in enc]),
                         reference["big_decoded"]):
        np.testing.assert_array_equal(got, want)
    after = proc_shm.metrics.snapshot()["counters"]
    for name in ("serve_shm_sends", "serve_shm_replies"):
        assert after.get(name, 0) - before.get(name, 0) >= 1, name
    assert after.get("serve_shm_fallbacks", 0) == 0
    # every lane the parent claimed is free again once the batches settled
    ring = proc_shm._swap.current.proc().rings
    n = sum(c.n_lanes for c in ring._classes)
    assert bytes(ring._shm.buf[:n]) == bytes(n)


def test_encode_task_owns_its_memory(world, proc_pipe, monkeypatch):
    """The pool pickles a task after `submit` returns, so a volume it ships
    must not be a view of the batch's host buffer (pinned memory on the
    card): each is a copy that owns its data."""
    hosts, shipped = [], []
    host = service_lib._DeviceBatch.host
    call = proc_pipe._proc_call

    def spy_host(self):
        out = host(self)
        hosts.append(out)
        return out

    def spy_call(bundle, fn, *args, **kw):
        if fn is port_loader.worker_encode_batch:
            shipped.extend(args[0])
        return call(bundle, fn, *args, **kw)

    monkeypatch.setattr(service_lib._DeviceBatch, "host", spy_host)
    monkeypatch.setattr(proc_pipe, "_proc_call", spy_call)
    _encode_all(proc_pipe, world["images"][:2])
    assert hosts and shipped
    for vol in shipped:
        assert vol.flags.owndata and vol.flags.c_contiguous
        assert not any(np.shares_memory(vol, h) for h in hosts)


@pytest.mark.parametrize("transport", ["pipe", "shm"])
def test_corrupted_payload_fails_only_its_request(reference, transport,
                                                  request):
    svc = request.getfixturevalue(f"proc_{transport}")
    plan = faults.FaultPlan([faults.FaultSpec(
        site="serve.rans", action="corrupt", times=1)], seed=0)
    with faults.installed(plan):
        futs = [svc.submit_decode(s) for s in reference["streams"][:3]]
        excs = [f.exception(timeout=120) for f in futs]
    hit = [e for e in excs if e is not None]
    assert len(hit) == 1 and isinstance(hit[0], IntegrityError)
    for f, e, want in zip(futs, excs, reference["decoded"]):
        if e is None:
            np.testing.assert_array_equal(f.result(0), want)


def test_mode3_payload_decodes_to_the_same_symbols(world, thread_svc,
                                                   proc_shm, monkeypatch):
    """A client's mode-3 stream: the process backend decodes it on the
    bridge thread through the bundle's codec (K3; on the CPU its plain
    version, as the thread backend does), never in a child, beside mode-2
    batchmates that go to the pool; a child refuses mode 3 typed."""
    vol = thread_svc.codec.decode(service_lib.parse_stream(
        world["jsvc"].encode(world["images"][0]).stream)[0])
    mode3 = frame_stream(thread_svc.codec.encode(vol, mode="wavefront_pl"),
                         BUCKET, BUCKET)
    mode2 = _encode_all(thread_svc, world["images"][:1])[0].stream
    pooled = []
    call = proc_shm._proc_call

    def spy_call(bundle, fn, *args, **kw):
        if fn is port_loader.worker_decode_batch:
            pooled.append(len(args[0]))
        return call(bundle, fn, *args, **kw)

    monkeypatch.setattr(proc_shm, "_proc_call", spy_call)
    want = _decode_all(thread_svc, [mode3, mode2])
    got = _decode_all(proc_shm, [mode3, mode2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sum(pooled) == 1          # only the mode-2 lane reached a child
    saved = port_loader._worker_codec
    port_loader._worker_codec = port_loader.codec_from_spec(
        port_loader.make_codec_spec(thread_svc.codec))
    try:
        (sym, exc), = port_loader.worker_decode_batch(
            [service_lib.parse_stream(mode3)[0]])
        assert sym is None and isinstance(exc, ValueError)
        assert "decoded on the card" in str(exc)
    finally:
        port_loader._worker_codec = saved


def test_trace_contexts_ride_the_task(world, proc_pipe):
    """Sampled contexts go to the child and back bit-equal: the child's
    coding span lands under the request's trace id, no mismatch."""
    proc_pipe.tracer.set_sample_rate(1.0)
    try:
        fut = proc_pipe.submit_encode(world["images"][0])
        fut.result(120)
        tid = fut.trace.trace_id
        spans = proc_pipe.tracer.snapshot(tid)["spans"]
    finally:
        proc_pipe.tracer.set_sample_rate(0.0)
    proc_spans = [s for s in spans if s["name"] == trace_lib.SPAN_ENTROPY_PROC]
    assert proc_spans and proc_spans[0]["args"]["pid"] in {
        p["pid"] for p in proc_pipe._proc_warm}
    assert proc_pipe.metrics.counter("serve_trace_proc_mismatch").value == 0


# -- surviving children that die or hang ----------------------------------------

def test_killed_child_rebuilds_the_pool_once(world, reference, proc_pipe):
    import signal
    rebuilds = proc_pipe.metrics.counter("serve_entropy_proc_rebuilds")
    before = rebuilds.value
    pids = list(proc_pipe._swap.current.proc().pool._processes)
    for pid in pids:
        os.kill(pid, signal.SIGKILL)
    enc = _encode_all(proc_pipe, world["images"][:1])
    assert enc[0].stream == reference["streams"][0]
    assert rebuilds.value == before + 1
    assert not set(proc_pipe._swap.current.proc().pool._processes) & set(pids)
    np.testing.assert_array_equal(
        _decode_all(proc_pipe, reference["streams"][:1])[0],
        reference["decoded"][0])


def test_hung_child_times_out_typed_and_is_replaced(world, reference,
                                                    proc_pipe):
    rebuilds = proc_pipe.metrics.counter("serve_entropy_proc_rebuilds")
    before = rebuilds.value
    bundle = proc_pipe._swap.current
    proc_pipe._ping_children(bundle)          # every child warm and idle
    wedged = list(bundle.proc().pool._processes.values())
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="stuck"):
        proc_pipe._proc_call(bundle, time.sleep, 30.0, timeout=2.0)
    assert time.monotonic() - t0 < 20.0
    assert rebuilds.value == before + 1
    # killed, not left to sleep: the old pool's manager thread reaps them
    # (a waitpid here can lose that race), so wait for their exit codes
    deadline = time.monotonic() + 30.0
    while (any(p.exitcode is None for p in wedged)
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert [p.exitcode for p in wedged] == [-9] * len(wedged)
    enc = _encode_all(proc_pipe, world["images"][:1])
    assert enc[0].stream == reference["streams"][0]


def test_submit_that_loses_a_swap_race_retries(world, reference, proc_shm):
    """Another bridge thread shut the pool down between our read and the
    submit: the bare RuntimeError is retried on a fresh pool (and its
    ring), the old ring is unlinked."""
    rebuilds = proc_shm.metrics.counter("serve_entropy_proc_rebuilds")
    before = rebuilds.value
    old = proc_shm._swap.current.proc()
    old.shutdown(wait=False)
    enc = _encode_all(proc_shm, world["images"][:1])
    assert enc[0].stream == reference["streams"][0]
    assert rebuilds.value == before + 1
    assert proc_shm._swap.current.proc() is not old
    assert not os.path.exists(f"/dev/shm/{old.rings.name}")


def test_shm_refused_typed_when_dev_shm_is_too_small(proc_shm, monkeypatch):
    class _Tiny:
        f_bavail, f_frsize = 1, 4096
    monkeypatch.setattr(service_lib.os, "statvfs", lambda path: _Tiny())
    with pytest.raises(RuntimeError, match="/dev/shm"):
        proc_shm._make_entropy_proc(proc_shm._swap.current.proc_initargs)


def test_drain_stops_the_children_and_unlinks_the_ring(proc_shm):
    proc = proc_shm._swap.current.proc()
    children = list(proc.pool._processes.values())
    seg = f"/dev/shm/{proc.rings.name}"
    spec_path = proc_shm._swap.current.proc_initargs[0]
    assert children and os.path.exists(seg) and os.path.exists(spec_path)
    assert proc_shm.drain(timeout=60)
    assert not any(p.is_alive() for p in children)
    assert not os.path.exists(seg)
    assert not os.path.exists(spec_path)
    assert proc_shm._swap.current.proc() is None
