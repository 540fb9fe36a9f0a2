"""The port service's hot swap, rollback and their refusals on the CPU (the
cases of tests/test_serve_hotswap.py, on the port's service), the swap
state machine against the JAX package's, the census of a process-backend
bundle's children and shared-memory segments across a prepare and its
abort, and no native build across any lifecycle operation.

The tiny configuration of tests/test_train_step.py at bucket (16, 24); a
second model's checkpoint saved with the manifest a swap verifies. Every
test leaves the module's service back on its original model. Exact.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from dsin_tpu.serve import MetricsRegistry as JaxMetrics
from dsin_tpu.serve import ModelBundle as JaxBundle
from dsin_tpu.serve import SwapCoordinator as JaxCoordinator
from dsin_tpu_torch import native_build
from dsin_tpu_torch.coding.loader import load_model_state
from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.serve import (CompressionService,
                                  ConditionalRollbackRefused,
                                  ManifestMismatch, MetricsRegistry,
                                  ModelBundle, ServeError, ServiceConfig,
                                  SwapCoordinator, SwapError)
from dsin_tpu_torch.train import checkpoint as ckpt_lib
from dsin_tpu_torch.utils import faults
from test_train_step import tiny_ae_cfg, tiny_pc_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BUCKETS = ((16, 24),)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.uninstall()
    yield
    faults.uninstall()


@pytest.fixture(scope="module")
def cfg_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("swap_cfg")
    ae_p, pc_p = str(d / "ae"), str(d / "pc")
    with open(ae_p, "w") as f:
        f.write(str(tiny_ae_cfg(crop_size=(16, 24), batch_size=1)))
    with open(pc_p, "w") as f:
        f.write(str(tiny_pc_cfg()))
    return ae_p, pc_p


def save_model_ckpt(cfg_files, out_dir, seed, sinet=False, buckets=BUCKETS):
    """A swap-eligible checkpoint: the tiny model at `seed`, saved with the
    manifest identity the service verifies."""
    ae = parse_config_file(cfg_files[0]).replace(AE_only=not sinet)
    pc = parse_config_file(cfg_files[1])
    ckpt_lib.save_checkpoint(
        out_dir, ckpt_lib.state_from_model(build_model(
            ae, pc, device="cpu", seed=seed)),
        manifest_extra={"pc_config_sha256": ckpt_lib.config_sha256(pc),
                        "seed": seed,
                        "buckets": [list(b) for b in buckets]})
    return out_dir


def _edit_manifest(ckpt, **changes):
    path = os.path.join(ckpt, ckpt_lib.MANIFEST_NAME)
    with open(path) as f:
        manifest = json.load(f)
    manifest.update(changes)
    with open(path, "w") as f:
        json.dump(manifest, f)


@pytest.fixture(scope="module")
def swap_rig(cfg_files, tmp_path_factory):
    ae_p, pc_p = cfg_files
    d = tmp_path_factory.mktemp("hotswap")
    ckpt_b = save_model_ckpt(cfg_files, str(d / "ckpt_b"), seed=1)
    svc = CompressionService(ServiceConfig(
        ae_config=ae_p, pc_config=pc_p, buckets=BUCKETS, max_batch=2,
        max_wait_ms=2.0, max_queue=64, workers=1, entropy_workers=1,
        device="cpu")).start()
    svc.warmup()
    yield svc, ckpt_b
    assert svc.drain()


def _imgs(n=2):
    rng = np.random.default_rng(7)
    return [rng.integers(0, 255, (16, 24, 3), dtype=np.uint8)
            for _ in range(n)]


def _await_backlog(svc, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while svc._batcher.depth > 0 and time.monotonic() < deadline:
        time.sleep(0.01)


def test_hot_swap_under_load_bit_identity_and_rollback(swap_rig):
    svc, ckpt_b = swap_rig
    imgs = _imgs()
    digest_a = svc.model_digest
    a_streams = [svc.encode(img).stream for img in imgs]
    builds = native_build.build_count()
    futures, stop = [], threading.Event()

    def submit():
        i = 0
        while not stop.is_set():
            try:
                futures.append((i % len(imgs), svc.submit_encode(
                    imgs[i % len(imgs)])))
            except ServeError:
                time.sleep(0.002)
            i += 1

    t = threading.Thread(target=submit)
    t.start()
    try:
        info = svc.swap_model(ckpt_b)
    finally:
        stop.set()
        t.join(30)
    digest_b = info["digest"]
    assert digest_b != digest_a and svc.model_digest == digest_b
    _await_backlog(svc)
    b_streams = [svc.encode(img).stream for img in imgs]
    for i, img in enumerate(imgs):
        futures.append((i, svc.submit_encode(img)))
    new = 0
    for idx, f in futures:
        res = f.result(timeout=60)
        if res.model_digest == digest_a:
            assert res.stream == a_streams[idx]
        else:
            assert res.model_digest == digest_b
            assert res.stream == b_streams[idx]
            new += 1
    assert new > 0 and b_streams[0] != a_streams[0]
    svc.rollback()
    assert svc.model_digest == digest_a
    assert [svc.encode(img).stream for img in imgs] == a_streams
    assert native_build.build_count() == builds
    counters = svc.metrics.snapshot()["counters"]
    assert counters["serve_swaps"] >= 1 and counters["serve_rollbacks"] >= 1


def test_swap_metrics_and_health_surface(swap_rig):
    svc, ckpt_b = swap_rig
    digest_a = svc.model_digest
    svc.swap_model(ckpt_b)
    try:
        snap = svc.metrics.snapshot()
        model = snap["info"]["serve_model_digest"]
        assert model["digest"] == svc.model_digest != digest_a
        assert model["prev_digest"] == digest_a
        assert model["swap_state"] == 0 and model["ckpt"] == ckpt_b
        assert snap["gauges"]["serve_swap_state"] == 0
        assert svc.health()["model"]["digest"] == svc.model_digest
        events = [e["kind"] for e in svc.flight.snapshot()]
        assert "swap_prepared" in events and "swap_commit" in events
    finally:
        svc.rollback()
    assert svc.health()["model"]["digest"] == digest_a
    assert svc.flight.snapshot()[-1]["kind"] == "swap_rollback"


@pytest.mark.parametrize("change,match", [
    ({"pc_config_sha256": "0" * 16}, "probability-model"),
    ({"buckets": [[64, 64]]}, "bucket ladder")])
def test_swap_refuses_a_manifest_that_disagrees(swap_rig, tmp_path, change,
                                                match):
    svc, _ = swap_rig
    ckpt = save_model_ckpt((svc.config.ae_config, svc.config.pc_config),
                           str(tmp_path / "bad"), seed=2)
    _edit_manifest(ckpt, **change)
    digest_a = svc.model_digest
    with pytest.raises(ManifestMismatch, match=match):
        svc.swap_model(ckpt)
    assert svc.model_digest == digest_a
    assert svc.health()["model"]["swap_state"] == 0


def test_swap_refuses_legacy_manifestless_checkpoint(swap_rig, tmp_path):
    svc, _ = swap_rig
    ckpt = save_model_ckpt((svc.config.ae_config, svc.config.pc_config),
                           str(tmp_path / "legacy"), seed=2)
    os.remove(os.path.join(ckpt, ckpt_lib.MANIFEST_NAME))
    errors = svc.metrics.counter("serve_swap_errors").value
    with pytest.raises(ManifestMismatch, match="no manifest"):
        svc.swap_model(ckpt)
    assert svc.metrics.counter("serve_swap_errors").value > errors


def test_cold_start_warns_on_legacy_and_refuses_mismatch(cfg_files,
                                                         tmp_path):
    ae_p, pc_p = cfg_files
    ckpt = save_model_ckpt(cfg_files, str(tmp_path / "ok"), seed=1)
    load_model_state(ae_p, pc_p, ckpt, device="cpu")
    _edit_manifest(ckpt, partition_digests={"encoder": "0" * 16})
    with pytest.raises(ManifestMismatch, match="encoder"):
        load_model_state(ae_p, pc_p, ckpt, device="cpu")
    os.remove(os.path.join(ckpt, ckpt_lib.MANIFEST_NAME))
    with pytest.warns(UserWarning, match="predates manifest"):
        load_model_state(ae_p, pc_p, ckpt, device="cpu")


def test_double_prepare_refused_and_abort_recovers(swap_rig):
    svc, ckpt_b = swap_rig
    digest_a = svc.model_digest
    info = svc.prepare_swap(ckpt_b)
    try:
        assert set(info["split"]) == {"load_s", "warm_s", "pool_s",
                                      "canary_s"}
        assert svc.health()["model"]["swap_state"] == 2
        with pytest.raises(SwapError, match="already staged"):
            svc.prepare_swap(ckpt_b)
        assert svc.encode(_imgs(1)[0]).model_digest == digest_a
    finally:
        svc.abort_swap()
    assert svc.health()["model"]["swap_state"] == 0
    with pytest.raises(SwapError, match="no staged bundle"):
        svc.commit_swap()
    svc.prepare_swap(ckpt_b)
    try:
        with pytest.raises(SwapError, match="not the expected"):
            svc.commit_swap(expect_digest="beef" * 4)
    finally:
        svc.abort_swap()
    assert svc.model_digest == digest_a


def test_conditional_rollback_refuses_wrong_current(swap_rig):
    svc, ckpt_b = swap_rig
    digest_a = svc.model_digest
    info = svc.swap_model(ckpt_b)
    try:
        with pytest.raises(ConditionalRollbackRefused,
                           match="conditional rollback"):
            svc.rollback(expect_current="not-the-digest")
        assert svc.model_digest == info["digest"]
        svc.rollback(expect_current=info["digest"])
    finally:
        if svc.model_digest != digest_a:
            svc.rollback()
    assert svc.model_digest == digest_a


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_abort_cancels_in_flight_prepare(impl):
    """An abort landing while a prepare still loads refuses the late stage;
    the preparer's cleanup releases the claim; a fresh cycle works. The
    port's coordinator and the JAX package's give the same answers."""
    if impl == "port":
        coord = SwapCoordinator(ModelBundle(0, "d0", None, None),
                                MetricsRegistry())
        bundle = lambda e, d: ModelBundle(e, d, None, None)  # noqa: E731
    else:
        coord = JaxCoordinator(JaxBundle(0, "d0", None, None, []),
                               JaxMetrics())
        bundle = lambda e, d: JaxBundle(e, d, None, None, [])  # noqa: E731
    epoch = coord.begin_prepare()
    assert coord.snapshot()["swap_state"] == 1
    assert coord.abort() == []
    with pytest.raises(RuntimeError, match="aborted while"):
        coord.stage(bundle(epoch, "d1"))
    coord.abandon_prepare()
    coord.stage(bundle(coord.begin_prepare(), "d2"))
    assert coord.snapshot()["swap_state"] == 2
    assert coord.commit(expect_digest="d2") == []
    assert coord.current.digest == "d2" and coord.live_epochs() == [2, 0]
    assert coord.rollback() == [] and coord.current.digest == "d0"
    assert [b.digest for b in coord.all_bundles()] == ["d0", "d2"]


def test_rollback_with_no_prev_is_typed(cfg_files):
    ae_p, pc_p = cfg_files
    svc = CompressionService(ServiceConfig(
        ae_config=ae_p, pc_config=pc_p, buckets=BUCKETS, max_batch=1,
        max_wait_ms=1.0, max_queue=8, workers=1, device="cpu")).start()
    try:
        with pytest.raises(SwapError, match="roll back"):
            svc.rollback()
    finally:
        assert svc.drain()


@pytest.mark.parametrize("after", [0, 1])
def test_kill_in_a_swap_window_keeps_old_model(swap_rig, after):
    """The serve.swap fault site in the prepare window (its first visit)
    and the commit window (its second): the crash escapes, nothing stays
    staged, the claim is released, and the old model serves bit for bit."""
    svc, ckpt_b = swap_rig
    img = _imgs(1)[0]
    digest_a = svc.model_digest
    ref = svc.encode(img).stream
    plan = faults.FaultPlan([faults.FaultSpec(
        site="serve.swap", action="crash", after=after, times=1)], seed=0)
    with faults.installed(plan):
        with pytest.raises(faults.InjectedCrash):
            svc.swap_model(ckpt_b)
    assert plan.activations["serve.swap"] == 1
    assert svc.model_digest == digest_a
    assert svc.health()["model"]["swap_state"] == 0
    assert svc.encode(img).stream == ref


def test_corrupted_manifest_is_refused_typed(swap_rig):
    """The ckpt.manifest fault site corrupts the incoming manifest as it is
    read: a typed refusal (IntegrityError or ManifestMismatch, both
    ValueErrors), never an adoption."""
    svc, ckpt_b = swap_rig
    digest_a = svc.model_digest
    plan = faults.FaultPlan([faults.FaultSpec(
        site="ckpt.manifest", action="corrupt", flips=64, times=1)], seed=0)
    with faults.installed(plan):
        with pytest.raises(ValueError):
            svc.swap_model(ckpt_b)
    assert plan.activations["ckpt.manifest"] == 1
    assert svc.model_digest == digest_a
    assert svc.health()["model"]["swap_state"] == 0


def test_sessions_expire_typed_across_a_swap(cfg_files, tmp_path):
    """A commit and a rollback clear the session store: a decode_si on a
    session opened before answers typed SessionExpired, and a re-opened
    session serves."""
    from dsin_tpu_torch.serve import SessionExpired
    ae_p, pc_p = cfg_files
    ckpt = save_model_ckpt(cfg_files, str(tmp_path / "si"), seed=5,
                           sinet=True)
    svc = CompressionService(ServiceConfig(
        ae_config=ae_p, pc_config=pc_p, buckets=BUCKETS, max_batch=2,
        max_wait_ms=2.0, entropy_workers=1, enable_si=True,
        device="cpu")).start()
    try:
        svc.warmup()
        img = _imgs(1)[0]
        stream = svc.encode(img).stream
        sid = svc.open_session(img)
        svc.decode_si(stream, sid)
        svc.swap_model(ckpt)
        with pytest.raises(SessionExpired):
            svc.decode_si(stream, sid)
        sid = svc.open_session(img)
        assert svc.decode_si(stream, sid).shape == img.shape
        svc.rollback()
        with pytest.raises(SessionExpired):
            svc.decode_si(stream, sid)
        counters = svc.metrics.snapshot()["counters"]
        assert counters["serve_session_evictions_swap"] >= 1
    finally:
        assert svc.drain()


def _census():
    from multiprocessing import active_children
    return (sorted(p.pid for p in active_children()),
            sorted(n for n in os.listdir("/dev/shm")
                   if n.startswith("dsintorch-")))


def test_prepare_abort_leaves_no_children_or_segments(cfg_files, tmp_path):
    """A process-backend bundle owns its pool, its spec file and
    its shm ring. A prepare starts 2 more children and a ring; its abort
    reaps those children, unlinks the ring and removes the spec file; a
    swap's commit keeps both warm bundles, and a later commit releases the
    one it displaces; the drain releases all."""
    ae_p, pc_p = cfg_files
    ckpt = save_model_ckpt(cfg_files, str(tmp_path / "b"), seed=3)
    before = _census()
    svc = CompressionService(ServiceConfig(
        ae_config=ae_p, pc_config=pc_p, buckets=BUCKETS, max_batch=2,
        max_wait_ms=2.0, entropy_workers=2, entropy_backend="process",
        transport="shm", device="cpu")).start()
    try:
        svc.warmup()
        live = _census()
        assert len(live[0]) == len(before[0]) + 2
        assert len(live[1]) == len(before[1]) + 1
        info = svc.prepare_swap(ckpt)
        staged = svc._swap.staged
        spec = os.path.dirname(staged.proc_initargs[0])
        assert info["warm"]["proc_workers"] == 2 and os.path.isdir(spec)
        during = _census()
        assert len(during[0]) == len(live[0]) + 2
        assert len(during[1]) == len(live[1]) + 1
        svc.abort_swap()
        assert _census() == live
        assert not os.path.exists(spec)
        img = _imgs(1)[0]
        ref = svc.encode(img).stream
        svc.swap_model(ckpt)
        assert len(_census()[0]) == len(live[0]) + 2
        svc.rollback()
        assert svc.encode(img).stream == ref
        # a commit that displaces the bundle kept for rollback reaps its
        # children and unlinks its ring on a thread of its own
        svc.swap_model(ckpt)
        deadline = time.monotonic() + 60
        while (len(_census()[0]), len(_census()[1])) != (
                len(live[0]) + 2, len(live[1]) + 1):
            assert time.monotonic() < deadline, _census()
            time.sleep(0.05)
    finally:
        assert svc.drain()
    assert _census() == before


def test_commit_retires_the_displaced_bundle_off_the_callers_thread(
        cfg_files, tmp_path, monkeypatch):
    """A commit that displaces the bundle kept for rollback returns without
    waiting for its retire (on the process backend, the join of its
    children): the retire runs on a thread of its own, and the drain waits
    for it before the last bundles retire."""
    from dsin_tpu_torch.serve import swap as swap_lib
    ae_p, pc_p = cfg_files
    ckpt = save_model_ckpt(cfg_files, str(tmp_path / "b"), seed=5)
    svc = CompressionService(ServiceConfig(
        ae_config=ae_p, pc_config=pc_p, buckets=BUCKETS, max_batch=2,
        max_wait_ms=2.0, entropy_workers=1, device="cpu")).start()
    release, retired = threading.Event(), []
    real = swap_lib.ModelBundle.retire

    def held_retire(bundle):
        assert release.wait(60)
        retired.append((bundle.epoch, threading.current_thread().name))
        real(bundle)

    try:
        svc.warmup()
        svc.swap_model(ckpt)
        svc.rollback()
        kept = svc._swap.snapshot()
        displaced = [b.epoch for b in svc._swap.all_bundles()
                     if b.digest == kept["prev_digest"]]
        monkeypatch.setattr(swap_lib.ModelBundle, "retire", held_retire)
        info = svc.swap_model(ckpt)
        assert retired == [] and info["commit_ms"] >= 0
        assert svc._swap.snapshot()["prev_digest"] == kept["digest"]
    finally:
        release.set()
        assert svc.drain()
    assert retired[0] == (displaced[0], "serve-retire")
    assert len(retired) == 3       # and the drain retired current and prev


def test_no_native_build_across_the_lifecycle(cfg_files, tmp_path):
    """Prepare, commit, abort, rollback and a canary (with the
    prober on and the watchdog armed) build nothing after warmup."""
    ae_p, pc_p = cfg_files
    ckpt = save_model_ckpt(cfg_files, str(tmp_path / "b"), seed=4,
                           sinet=True)
    svc = CompressionService(ServiceConfig(
        ae_config=ae_p, pc_config=pc_p, buckets=BUCKETS, max_batch=2,
        max_wait_ms=2.0, entropy_workers=1, enable_si=True,
        canary_every_s=0.05, rollback_watchdog_window_s=0.5,
        device="cpu")).start()
    try:
        svc.warmup()
        builds = native_build.build_count()
        svc.prepare_swap(ckpt)
        svc.canary_goldens(staged=True)
        svc.abort_swap()
        svc.swap_model(ckpt)
        svc.rollback()
        assert svc.run_canary()["status"] in ("ok", "busy")
        deadline = time.monotonic() + 30
        while svc.metrics.counter("serve_canary_runs").value < 2:
            assert time.monotonic() < deadline, "the prober never ran"
            time.sleep(0.02)
        assert native_build.build_count() == builds
    finally:
        assert svc.drain()


@pytest.mark.parametrize("battery,section", [
    ("--hotswap_only", "hotswap"), ("--degraded_only", "degraded_model")])
def test_chaos_bench_batteries_smoke(tmp_path, battery, section):
    """The port's chaos bench at its smoke size: exit 0 and no violation;
    every scenario of the battery reported."""
    from dsin_tpu_torch.tools import chaos_bench
    out = str(tmp_path / "c.json")
    assert chaos_bench.main(["--smoke", battery, "--device", "cpu",
                             "--entropy_workers", "1", "--out", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["violations"] == []
    want = ({"kill_prepare", "kill_commit", "corrupt_manifest",
             "swap_under_load", "rollback", "watchdog_rollback"}
            if section == "hotswap" else
            {"si_match_alarm", "canary_refusal", "forced_commit_watchdog"})
    assert set(report[section]["scenarios"]) == want
    assert report[section]["steady_builds"] == 0


@pytest.mark.parametrize("battery", ["--autoscale_only",
                                     "--transport_only", "--federation_only",
                                     None])
def test_chaos_bench_refuses_unported_batteries(battery, capsys):
    from dsin_tpu_torch.tools import chaos_bench
    with pytest.raises(SystemExit):
        chaos_bench.main(["--smoke", "--device", "cpu"]
                         + ([battery] if battery else []))
    assert "item 11g" in capsys.readouterr().err


def test_coordinator_under_thread_stress():
    """16 threads (more than this host's cores) prepare, stage, commit,
    abort and roll back one coordinator with a 10 us switch interval: the
    counters equal the transitions that returned, one prepare at a time
    ever holds the claim, and current and prev are never one bundle."""
    import sys
    coord = SwapCoordinator(ModelBundle(0, "d0", None, None),
                            MetricsRegistry())
    done = {"commits": 0, "rollbacks": 0, "aborted": 0}
    lock = threading.Lock()
    bad = []

    def worker(k):
        for i in range(200):
            try:
                if (i + k) % 3 == 0:
                    epoch = coord.begin_prepare()
                    try:
                        coord.stage(ModelBundle(epoch, f"d{epoch}", None,
                                                None))
                    except SwapError:
                        coord.abandon_prepare()
                        continue
                    coord.commit(expect_digest=f"d{epoch}")
                    with lock:
                        done["commits"] += 1
                elif (i + k) % 3 == 1:
                    coord.rollback()
                    with lock:
                        done["rollbacks"] += 1
                else:
                    if coord.abort():
                        with lock:
                            done["aborted"] += 1
            except SwapError:
                pass
            snap = coord.snapshot()
            if snap["prev_digest"] == snap["digest"]:
                bad.append(snap)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    counters = coord.metrics.snapshot()["counters"]
    assert counters["serve_swaps"] == done["commits"] > 0
    assert counters["serve_rollbacks"] == done["rollbacks"] > 0
    assert coord.snapshot()["swap_state"] in (0, 2)
