"""The port's CompressionService on the card: stream and event ordering
across worker streams and the entropy pool, K2 once per SI batch, the
process entropy backend (shm lanes) against the thread backend, and a hot
swap under load with quality telemetry on (K2 still once per SI batch).

Every test here needs an NVIDIA card; on a machine without one they skip
(decided inside the `cuda` fixture, so every pytest-xdist worker collects
the same tests). This file imports no jax:

    python -m pytest --noconftest -q tests/test_torch_serve_gpu.py

The tiny configuration (20x24 patches) at one 80x96 bucket, 2 workers
(each on its own CUDA stream), 2 entropy threads, batches of 4. Requests
served concurrently must give streams and images bit-equal to the same
requests served one at a time: every batch is padded to 4 lanes, so only
the other lanes differ, and a copy read before its event, or a prep read
before it was complete, would show as a difference. The process backend
must give the thread backend's streams and images, bit for bit, from
children that hold no CUDA context and built nothing.
"""

import dataclasses

import threading

import numpy as np
import pytest
import torch

from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.ops import sifinder_kernel as sk
from dsin_tpu_torch.serve import (CompressionService, ServiceConfig,
                                  SessionExpired)
from dsin_tpu_torch.serve.service import DECODE_SI

BUCKET = (80, 96)
N = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.fixture
def service(cuda, tmp_path):
    ae, pc = tiny_configs()
    paths = []
    for name, cfg in (("ae", ae), ("pc", pc)):
        paths.append(str(tmp_path / name))
        with open(paths[-1], "w") as f:
            f.write(str(cfg))
    svc = CompressionService(ServiceConfig(
        ae_config=paths[0], pc_config=paths[1], buckets=(BUCKET,),
        max_batch=4, max_wait_ms=20.0, workers=2, entropy_workers=2,
        enable_si=True, seed=2)).start()
    svc.warmup()
    yield svc
    assert svc.drain()


def _images(seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (BUCKET[0] // 8, (BUCKET[1] + 16) // 8, 3))
    smooth = np.kron(base, np.ones((8, 8, 1)))
    side = smooth[:, 16:].astype(np.uint8)
    imgs = [np.clip(smooth[:, :BUCKET[1]] + rng.normal(0, 6, smooth[
        :, :BUCKET[1]].shape), 0, 255).astype(np.uint8) for _ in range(N)]
    imgs[1] = imgs[1][:70, :90]               # padded to the bucket
    return side, imgs


def _concurrently(fn, items):
    out = [None] * len(items)

    def run(i):
        out[i] = fn(items[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.gpu
def test_concurrent_requests_equal_one_at_a_time(service):
    side, imgs = _images(0)
    sid = service.open_session(side)
    alone = [service.encode(img) for img in imgs]
    together = _concurrently(service.encode, imgs)
    assert [r.stream for r in together] == [r.stream for r in alone]
    streams = [r.stream for r in alone]
    for op in (service.decode, lambda s: service.decode_si(s, sid)):
        one = [op(s) for s in streams]
        many = _concurrently(op, streams)
        for a, b, img in zip(one, many, imgs):
            assert a.shape == img.shape and a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
    occupancy = service.metrics.histogram("serve_batch_occupancy").summary()
    assert occupancy["max"] > 0.25, "nothing was served in a shared batch"


@pytest.mark.gpu
def test_k2_once_per_si_batch(service):
    side, imgs = _images(1)
    sid = service.open_session(side)
    streams = [r.stream for r in _concurrently(service.encode, imgs)]
    si_batches = []
    service._batch_hook = lambda batch: si_batches.append(len(batch)) \
        if batch[0].key[0] == DECODE_SI else None
    sk.reset_launch_counts()
    _concurrently(lambda s: service.decode_si(s, sid), streams)
    launches = dict(sk.launch_counts)
    service._batch_hook = None
    assert sum(si_batches) == N
    assert launches == {"pearson_argmax": 0,
                        "pearson_argmax_shared": len(si_batches)}


@pytest.mark.gpu
def test_process_backend_equals_thread_backend(service):
    side, imgs = _images(2)
    sid = service.open_session(side)
    want = [service.encode(img) for img in imgs]
    streams = [r.stream for r in want]
    want_dec = [service.decode(s) for s in streams]
    want_si = [service.decode_si(s, sid) for s in streams]
    proc = CompressionService(dataclasses.replace(
        service.config, entropy_backend="process", transport="shm")).start()
    try:
        proc.warmup()
        assert len(proc._proc_warm) == 2
        for ping in proc._proc_warm:
            assert ping["cuda_initialized"] is False
            assert ping["native_builds"] == 0
        got = _concurrently(proc.encode, imgs)
        assert [r.stream for r in got] == streams
        psid = proc.open_session(side)
        for op, ref in ((proc.decode, want_dec),
                        (lambda s: proc.decode_si(s, psid), want_si)):
            for a, b in zip(_concurrently(op, streams), ref):
                np.testing.assert_array_equal(a, b)
        after = proc._ping_children(proc._swap.current)
        assert not any(p["cuda_initialized"] or p["native_builds"]
                       for p in after)
        assert proc.metrics.counter("serve_entropy_proc_rebuilds").value == 0
    finally:
        assert proc.drain()


@pytest.mark.gpu
def test_swap_under_load_keeps_k2_and_streams(service, tmp_path):
    """A hot swap while encodes and SI decodes run concurrently, quality
    telemetry on: every encode stream is model A's or model B's stream for
    that image alone, K2 launches once per SI batch (the SI-score decision
    keeps the search on the kernel: route 'kernel', scores off), and after
    the rollback A's streams come back; no native build in any of it."""
    from dsin_tpu_torch import native_build
    from dsin_tpu_torch.models.dsin import build_model
    from dsin_tpu_torch.train import checkpoint as ckpt_lib
    assert service.config.quality_enabled
    assert (service._si_route, service._si_scores_enabled) == ("kernel",
                                                              False)
    ae, pc = tiny_configs()
    ckpt = str(tmp_path / "b")
    ckpt_lib.save_checkpoint(ckpt, ckpt_lib.state_from_model(build_model(
        ae.replace(AE_only=False), pc, device="cpu", seed=7)),
        manifest_extra={"pc_config_sha256": ckpt_lib.config_sha256(pc),
                        "buckets": [list(BUCKET)]})
    side, imgs = _images(3)
    builds = native_build.build_count()
    a_streams = [service.encode(img).stream for img in imgs]
    digest_a = service.model_digest
    si_batches = []
    service._batch_hook = lambda batch: si_batches.append(
        [r.future for r in batch]) if batch[0].key[0] == DECODE_SI else None
    sk.reset_launch_counts()
    stop, results, errors, reopens = threading.Event(), [], [], []

    def load():
        try:
            sid = service.open_session(side)
            while not stop.is_set():
                for img in imgs:
                    res = service.encode(img)
                    results.append((img, res))
                    try:
                        service.decode_si(res.stream, sid)
                    except SessionExpired:   # a commit expired the session
                        reopens.append(sid)
                        sid = service.open_session(side)
        except Exception as e:  # noqa: BLE001 — any other failure fails
            errors.append(e)    # the test below

    threads = [threading.Thread(target=load) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        info = service.swap_model(ckpt)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=300)
    assert not errors, errors
    # the one commit expires each client's session; a session re-opened
    # while the commit landed (its prep built on A) expires once more
    assert len(reopens) <= 3 * len(threads), reopens
    torch.cuda.synchronize()
    service._batch_hook = None
    warm_and_probe = 1                  # the staged bundle's warm, 1 bucket
    ran = sum(any(f.exception(60) is None for f in futs)
              for futs in si_batches)
    assert sk.launch_counts == {"pearson_argmax": 0,
                                "pearson_argmax_shared": ran + warm_and_probe}
    b_streams = [service.encode(img).stream for img in imgs]
    index = {id(img): i for i, img in enumerate(imgs)}
    for img, res in results:
        i = index[id(img)]
        assert (res.model_digest, res.stream) in (
            (digest_a, a_streams[i]), (info["digest"], b_streams[i]))
    service.rollback()
    assert [service.encode(img).stream for img in imgs] == a_streams
    assert native_build.build_count() == builds
