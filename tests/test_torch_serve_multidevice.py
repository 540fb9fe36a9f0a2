"""The port's multi-device serve dataplane on the CPU: the five cases of
tests/test_serve_multidevice.py on the port's service at logical CPU
devices (`devices=("cpu",) * N`), then the JAX service at `devices=2`
(the conftest's forced host devices) against the port at ("cpu", "cpu").

  * N=1 against N=4: streams byte-equal, images element-equal, more than
    one device served;
  * 8 devices, three buckets, mixed shapes both ways: no native build
    after warmup, the census `2 * pairs`;
  * device 1's worker crashed through `_batch_hook`: device 0 keeps
    answering, the supervisor heals the slot onto device 1;
  * a rebalance warms the pairs new to its plan, then swaps; a concurrent
    call is skipped;
  * the observed-traffic rebalance;
  * the JAX service at devices=2 and the port at ("cpu", "cpu") from one
    JAX-written checkpoint: the same `serve_device_assignments`, streams
    byte-equal (every latent first asserted more than 1e-4 from a center
    midpoint, so float noise cannot flip a symbol);
  * `enable_si` with two devices refused with the JAX service's
    ValueError; the supervisor's auto rebalance; a prepare, commit and
    rollback at two devices (every device's weights on the new digest,
    then the old); every device's weights in storage of their own; the
    process backend at two devices, its children forks of the port's fork
    server, its streams the thread backend's.
Exact.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsin_tpu.serve import CompressionService as JaxService
from dsin_tpu.serve import ServiceConfig as JaxConfig
from dsin_tpu.train import checkpoint as jax_ckpt
from dsin_tpu.train import optim as jax_optim
from dsin_tpu.train.step import TrainState
from dsin_tpu_torch import bridge, native_build
from dsin_tpu_torch.coding import loader as port_loader
from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.serve import (CompressionService, EncodeResult,
                                  PlacementError, ServiceConfig)
from dsin_tpu_torch.train import checkpoint as ckpt_lib
from dsin_tpu_torch.utils import faults
from test_train_step import tiny_ae_cfg, tiny_pc_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BUCKETS = ((16, 24), (32, 48))
SHAPES = [(16, 24), (10, 17), (32, 48), (24, 40), (9, 33)]


@pytest.fixture(scope="module")
def cfg_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("multidevice_cfg")
    ae = tiny_ae_cfg(crop_size=(16, 24), batch_size=1)
    pc = tiny_pc_cfg()
    ae_p, pc_p = str(d / "ae"), str(d / "pc")
    for path, cfg in ((ae_p, ae), (pc_p, pc)):
        with open(path, "w") as f:
            f.write(str(cfg))
    return ae_p, pc_p


def _service(cfg_files, **over):
    ae_p, pc_p = cfg_files
    kw = dict(ae_config=ae_p, pc_config=pc_p, buckets=BUCKETS,
              max_batch=2, max_wait_ms=1.0, max_queue=64, workers=1,
              restart_backoff_s=0.05, restart_backoff_max_s=0.2,
              device="cpu")
    kw.update(over)
    svc = CompressionService(ServiceConfig(**kw)).start()
    svc.warmup()
    return svc


def _imgs(seed, n=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in (SHAPES * n)[:n]]


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def test_multidevice_results_bit_identical_to_single_device(cfg_files):
    svc1 = _service(cfg_files)
    svc4 = _service(cfg_files, devices=("cpu",) * 4)
    try:
        imgs = _imgs(0, n=10)
        builds = native_build.build_count()
        enc1 = [svc1.encode(im, timeout=60) for im in imgs]
        enc4 = [svc4.encode(im, timeout=60) for im in imgs]
        for a, b in zip(enc1, enc4):
            assert isinstance(b, EncodeResult)
            assert a.stream == b.stream
            assert a.bpp == b.bpp
        for res in enc1:
            np.testing.assert_array_equal(svc1.decode(res.stream, timeout=60),
                                          svc4.decode(res.stream, timeout=60))
        assert native_build.build_count() == builds
        snap = svc4.metrics.snapshot()
        served = [d for d in range(4) if snap["counters"].get(
            f"serve_device_batches_d{d}", 0) > 0]
        assert len(served) >= 2, snap["counters"]
        assert snap["gauges"]["serve_devices"] == 4
        assert snap["info"]["serve_device_assignments"] == \
            svc4.placement.plan.as_dict()
        assert svc4.health()["workers_configured"] == 4
    finally:
        svc1.drain()
        svc4.drain()


def test_mixed_shape_steady_state_builds_nothing_at_8_devices(cfg_files):
    svc = _service(cfg_files, devices=("cpu",) * 8,
                   buckets=((16, 24), (32, 48), (48, 64)))
    try:
        plan = svc.placement.plan
        assert {d for devs in plan.assignments.values()
                for d in devs} == set(range(8))
        builds = native_build.build_count()
        streams = [svc.encode(im, timeout=60).stream
                   for im in _imgs(1, n=12)]
        for s in streams:
            assert svc.decode(s, timeout=60).ndim == 3
        assert native_build.build_count() == builds
        assert svc.metrics.gauge("serve_executable_census").value \
            == 2 * len(plan.census())
    finally:
        svc.drain()


def test_kill_worker_on_one_device_other_devices_undisturbed(cfg_files):
    svc = _service(cfg_files, devices=("cpu", "cpu"), restart_backoff_s=0.3)
    crashed = []
    try:
        # uniform weights over 2 buckets x 2 devices: one bucket each
        assert svc.placement.plan.as_dict() == {"16x24": [0],
                                                "32x48": [1]}

        def hook(batch):  # noqa: ARG001 — kill device 1's executor once
            slot = int(threading.current_thread().name.rsplit("-", 1)[1])
            if slot % 2 == 1 and not crashed:
                crashed.append(slot)
                raise faults.InjectedCrash("die on device 1")

        svc._batch_hook = hook
        rng = np.random.default_rng(2)
        img_d0 = rng.integers(0, 255, (16, 24, 3), dtype=np.uint8)
        img_d1 = rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)
        restarts = svc.metrics.counter("serve_worker_restarts")
        builds = native_build.build_count()
        fb = svc.submit_encode(img_d1)
        assert isinstance(fb.exception(timeout=30), faults.InjectedCrash)
        # device 1's slot is dead (backoff window); device 0 serves
        assert _wait(lambda: svc.live_workers == 1), svc.live_workers
        for _ in range(3):
            assert isinstance(svc.encode(img_d0, timeout=30), EncodeResult)
        assert svc.metrics.counter("serve_worker_crashes").value == 1
        # heal: same slot, same device
        assert _wait(lambda: restarts.value >= 1 and svc.live_workers == 2)
        assert isinstance(svc.encode(img_d1, timeout=30), EncodeResult)
        assert native_build.build_count() == builds
        d1 = svc.metrics.counter("serve_device_batches_d1")
        assert _wait(lambda: d1.value >= 1)
        assert svc.metrics.counter("serve_device_batches_d0").value >= 3
    finally:
        svc._batch_hook = None
        svc.drain()


def test_rebalance_warms_new_pairs_then_swaps(cfg_files):
    svc = _service(cfg_files, devices=("cpu", "cpu"))
    try:
        before = dict(svc.placement.plan.as_dict())
        out = svc.rebalance_placement(weights={(16, 24): 10.0,
                                               (32, 48): 1.0})
        assert out["changed"], (before, out)
        assert out["warmed_pairs"] >= 1
        assert set(out["assignments"]["16x24"]) == {0, 1}
        assert svc.metrics.counter("serve_placement_rebalances").value == 1
        snap = svc.metrics.snapshot()
        assert snap["info"]["serve_device_assignments"] == out["assignments"]
        # the census only grows: the two pairs warmed at start stay warm
        assert snap["gauges"]["serve_executable_census"] == 2 * 4
        # one rebalancer at a time: a call arriving while another holds
        # the claim flag is skipped instead of racing warm-then-swap
        with svc._rebalance_lock:
            svc._rebalancing = True
        try:
            skipped = svc.rebalance_placement(
                weights={(16, 24): 1.0, (32, 48): 10.0})
            assert skipped["skipped"] and not skipped["changed"]
            assert svc.metrics.counter(
                "serve_placement_rebalances").value == 1
        finally:
            with svc._rebalance_lock:
                svc._rebalancing = False
        rng = np.random.default_rng(3)
        builds = native_build.build_count()
        for _ in range(4):
            res = svc.encode(rng.integers(0, 255, (16, 24, 3),
                                          dtype=np.uint8), timeout=30)
            assert svc.decode(res.stream, timeout=30).shape == (16, 24, 3)
            svc.encode(rng.integers(0, 255, (32, 48, 3), dtype=np.uint8),
                       timeout=30)
        assert native_build.build_count() == builds
    finally:
        svc.drain()


def test_observed_traffic_rebalance_uses_bucket_counters(cfg_files):
    svc = _service(cfg_files, devices=("cpu", "cpu"))
    try:
        rng = np.random.default_rng(4)
        for _ in range(6):
            svc.encode(rng.integers(0, 255, (16, 24, 3), dtype=np.uint8),
                       timeout=30)
        assert _wait(lambda: svc.metrics.counter(
            "serve_bucket_requests_16x24").value == 6)
        out = svc.rebalance_placement()
        assert len(out["assignments"]["16x24"]) >= len(
            out["assignments"]["32x48"]), out
        again = svc.rebalance_placement()
        assert again["assignments"] == out["assignments"]
        assert not again["changed"]
        assert svc.metrics.counter("serve_placement_rebalances").value == 2
    finally:
        svc.drain()


@pytest.fixture(scope="module")
def jax_ckpt_dir(cfg_files, tmp_path_factory):
    """The port's tiny model at seed 3, written by the JAX package's
    save_checkpoint with the manifest a service verifies."""
    ae = parse_config_file(cfg_files[0]).replace(AE_only=False)
    pc = parse_config_file(cfg_files[1])
    source = build_model(ae, pc, device="cpu", seed=3)
    params, stats = bridge.jax_from_state_dict(source.state_dict())
    jae = tiny_ae_cfg(crop_size=(16, 24), batch_size=1).replace(
        AE_only=False)
    jpc = tiny_pc_cfg()
    tx = jax_optim.build_optimizer(params, jae, jpc, num_training_imgs=4)
    ckpt = str(tmp_path_factory.mktemp("md_ckpt") / "ckpt")
    jax_ckpt.save_checkpoint(ckpt, TrainState(
        params=params, batch_stats=stats, opt_state=tx.init(params),
        step=jnp.int32(0)), manifest_extra={
            "pc_config_sha256": jax_ckpt.config_sha256(jpc), "seed": 3,
            "buckets": [list(b) for b in BUCKETS]})
    return ckpt


def test_jax_service_at_two_devices_equals_the_port(cfg_files, jax_ckpt_dir):
    ae_p, pc_p = cfg_files
    common = dict(ae_config=ae_p, pc_config=pc_p, ckpt=jax_ckpt_dir,
                  buckets=BUCKETS, max_batch=2, max_wait_ms=2.0,
                  entropy_workers=1, quality_enabled=False)
    # no JAX warmup: only the two (bucket, device) encodes used compile
    jsvc = JaxService(JaxConfig(devices=2, persistent_cache=False,
                                **common)).start()
    psvc = _service(cfg_files, devices=("cpu", "cpu"), **{
        k: v for k, v in common.items() if k not in ("ae_config",
                                                     "pc_config")})
    try:
        imgs = _imgs(5, n=5)
        model = psvc.server.model
        centers = np.sort(model.centers.detach().numpy())
        mids = (centers[1:] + centers[:-1]) / 2
        for img in imgs:
            bucket = psvc.policy.bucket_for(*img.shape[:2])
            x = np.pad(img.astype(np.float32),
                       ((0, bucket[0] - img.shape[0]),
                        (0, bucket[1] - img.shape[1]), (0, 0)), mode="edge")
            with torch.no_grad():
                z = model.encode(torch.from_numpy(x[None])).z.numpy()
            assert np.abs(z[..., None] - mids).min() > 1e-4
        jinfo = jsvc.metrics.snapshot()["info"]["serve_device_assignments"]
        pinfo = psvc.metrics.snapshot()["info"]["serve_device_assignments"]
        assert pinfo == jinfo == {"16x24": [0], "32x48": [1]}
        got = [psvc.encode(im, timeout=60).stream for im in imgs]
        want = [jsvc.encode(im, timeout=60).stream for im in imgs]
        assert got == want
        assert psvc.model_digest == jsvc.model_digest
        for d in range(2):
            assert psvc.metrics.counter(
                f"serve_device_batches_d{d}").value >= 1
    finally:
        psvc.drain()
        jsvc.drain()


def test_enable_si_at_two_devices_is_the_jax_refusal(cfg_files):
    ae_p, pc_p = cfg_files
    kw = dict(ae_config=ae_p, pc_config=pc_p, buckets=BUCKETS,
              enable_si=True, devices=2)
    with pytest.raises(ValueError) as want:
        JaxService(JaxConfig(persistent_cache=False, **kw)).start()
    with pytest.raises(ValueError) as got:
        CompressionService(ServiceConfig(device="cpu", **kw)).start()
    assert str(got.value) == str(want.value)
    assert "single device" in str(got.value)
    # an int beyond the visible devices: typed, before any model build
    with pytest.raises(PlacementError, match="visible"):
        CompressionService(ServiceConfig(ae_config=ae_p, pc_config=pc_p,
                                         buckets=BUCKETS, devices=2,
                                         device="cpu")).start()


def test_supervisor_rebalances_by_itself_on_skewed_traffic(cfg_files):
    svc = _service(cfg_files, devices=("cpu", "cpu"),
                   rebalance_check_every_s=0.2,
                   rebalance_hysteresis_checks=1, rebalance_cooldown_s=0.0)
    try:
        assert svc.placement.plan.as_dict() == {"16x24": [0], "32x48": [1]}
        rng = np.random.default_rng(6)
        auto = svc.metrics.counter("serve_auto_rebalances")
        deadline = time.monotonic() + 60
        while auto.value == 0 and time.monotonic() < deadline:
            futs = [svc.submit_encode(rng.integers(0, 255, (16, 24, 3),
                                                   dtype=np.uint8))
                    for _ in range(24)]
            for f in futs:
                f.result(30)
            time.sleep(0.3)
        assert auto.value >= 1
        assert svc.metrics.counter("serve_auto_rebalance_errors").value == 0
        assert svc.metrics.gauge("serve_traffic_skew").value >= 1.5
        assert svc.placement.plan.as_dict()["16x24"] == [0, 1]
        assert svc.metrics.snapshot()["info"][
            "serve_device_assignments"]["16x24"] == [0, 1]
    finally:
        svc.drain()


def _save_ckpt(cfg_files, out_dir, seed):
    ae = parse_config_file(cfg_files[0]).replace(AE_only=True)
    pc = parse_config_file(cfg_files[1])
    ckpt_lib.save_checkpoint(
        out_dir, ckpt_lib.state_from_model(build_model(
            ae, pc, device="cpu", seed=seed)),
        manifest_extra={"pc_config_sha256": ckpt_lib.config_sha256(pc),
                        "seed": seed,
                        "buckets": [list(b) for b in BUCKETS]})
    return out_dir


def _device_digests(svc):
    return [port_loader.served_digest(s.model, "fp32")
            for s in svc._swap.current.servers]


def test_swap_and_rollback_flip_every_device(cfg_files, tmp_path):
    ckpt_b = _save_ckpt(cfg_files, str(tmp_path / "b"), seed=9)
    svc = _service(cfg_files, devices=("cpu", "cpu"), entropy_workers=1)
    try:
        img = _imgs(7, n=3)[2]           # a (32, 48) image: device 1
        digest_a = svc.model_digest
        assert _device_digests(svc) == [digest_a] * 2
        stream_a = svc.encode(img).stream
        info = svc.prepare_swap(ckpt_b, canary=False)
        assert info["warm"]["pairs"] == 2
        staged = svc._swap.staged
        assert [port_loader.served_digest(s.model, "fp32")
                for s in staged.servers] == [info["digest"]] * 2
        builds = native_build.build_count()
        svc.commit_swap(expect_digest=info["digest"])
        assert _device_digests(svc) == [info["digest"]] * 2
        stream_b = svc.encode(img).stream
        assert stream_b != stream_a
        svc.rollback()
        assert svc.model_digest == digest_a
        assert _device_digests(svc) == [digest_a] * 2
        assert svc.encode(img).stream == stream_a
        assert native_build.build_count() == builds
    finally:
        svc.drain()


def test_each_device_holds_its_own_copy_of_the_weights(cfg_files):
    svc = _service(cfg_files, devices=("cpu",) * 3)
    try:
        servers = svc._swap.current.servers
        assert len(servers) == 3 and svc.server is servers[0]
        params = [dict(s.model.named_parameters()) for s in servers]
        for name, p0 in params[0].items():
            ptrs = {p[name].data_ptr() for p in params}
            assert len(ptrs) == 3, name
            for p in params[1:]:
                assert torch.equal(p[name], p0)
        assert len(set(_device_digests(svc))) == 1
    finally:
        svc.drain()


def test_process_backend_children_fork_from_the_fork_server(cfg_files):
    """Two logical devices on the process backend: the entropy children are
    forks of the port's fork server (`serve/procs.py`; the JAX
    package spawns them), never of this process; none initialises CUDA, and
    the streams are the thread backend's."""
    from multiprocessing import forkserver
    imgs = _imgs(8, n=5)
    ref = _service(cfg_files, devices=("cpu", "cpu"))
    try:
        want = [ref.encode(im, timeout=60).stream for im in imgs]
    finally:
        ref.drain()
    svc = _service(cfg_files, devices=("cpu", "cpu"),
                   entropy_backend="process", entropy_workers=2)
    try:
        pool = svc._swap.current.proc().pool
        assert pool._mp_context.get_start_method() == "forkserver"
        server = forkserver._forkserver._forkserver_pid
        for pid in pool._processes:
            with open(f"/proc/{pid}/stat") as f:
                assert int(f.read().rsplit(")", 1)[1].split()[1]) == server
        assert not any(p["cuda_initialized"] for p in svc._proc_warm)
        assert [svc.encode(im, timeout=60).stream for im in imgs] == want
    finally:
        svc.drain()
