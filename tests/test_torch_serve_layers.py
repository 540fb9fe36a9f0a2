"""The port's copies of the framework-free serve layers against their JAX
originals: the same scripted operations through both, compared exactly.

Buckets, the micro-batcher (batch sequences, session affinity, deadlines,
drain), the session store (LRU, TTL and byte evictions with an injected
clock, its counters), the metrics registry and its text, the tracer (head
sampling, spans, the Chrome export with times left out), the retry
policy, a seeded fault plan, and the DSRV framing (byte-equal, a v1 frame,
the typed corruption errors). Plus a stress test of the kernel launch
counters, which service workers bump concurrently.
"""

import re
import sys
import threading
import time

import numpy as np
import pytest

from dsin_tpu.serve import batcher as jbatch
from dsin_tpu.serve import buckets as jbuckets
from dsin_tpu.serve import metrics as jmetrics
from dsin_tpu.serve import session as jsession
from dsin_tpu.serve import service as jservice
from dsin_tpu.serve import trace as jtrace
from dsin_tpu.utils import faults as jfaults
from dsin_tpu.utils import retry as jretry
from dsin_tpu_torch.coding import probclass_kernel as pk
from dsin_tpu_torch.ops import epilogue as ek
from dsin_tpu_torch.ops import sifinder as sf
from dsin_tpu_torch.ops import sifinder_kernel as sk
from dsin_tpu_torch.serve import batcher as tbatch
from dsin_tpu_torch.serve import buckets as tbuckets
from dsin_tpu_torch.serve import metrics as tmetrics
from dsin_tpu_torch.serve import session as tsession
from dsin_tpu_torch.serve import service as tservice
from dsin_tpu_torch.serve import trace as ttrace
from dsin_tpu_torch.utils import faults as tfaults
from dsin_tpu_torch.utils import retry as tretry
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PKGS = {"jax": (jbuckets, jbatch, jsession, jmetrics, jtrace, jfaults,
                jretry, jservice),
        "torch": (tbuckets, tbatch, tsession, tmetrics, ttrace, tfaults,
                  tretry, tservice)}


def _outcome(fn):
    """(value, None) or (None, (exception type name, message))."""
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 — compared across packages
        return None, (type(e).__name__, str(e))


# -- buckets ------------------------------------------------------------------

@pytest.mark.parametrize("ladder", [((16, 24),), ((16, 24), (32, 48)),
                                    ((160, 600), (320, 1224)),
                                    ((8, 8), (16, 8), (8, 16))])
def test_buckets_route_pad_and_crop_alike(ladder):
    pols = {k: m[0].BucketPolicy(ladder) for k, m in PKGS.items()}
    assert pols["jax"].buckets == pols["torch"].buckets
    rng = np.random.default_rng(0)
    for h in (1, 7, 8, 15, 16, 17, 160, 300, 320, 321):
        for w in (1, 9, 24, 48, 590, 600, 1200, 1224, 1300):
            got = {k: _outcome(lambda p=p: p.bucket_for(h, w))
                   for k, p in pols.items()}
            assert got["jax"] == got["torch"], (h, w)
            bucket = got["jax"][0]
            if bucket is None or h * w > 4096:
                continue
            img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
            padded = [m[0].pad_to_bucket(img, bucket) for m in PKGS.values()]
            np.testing.assert_array_equal(padded[0], padded[1])
            np.testing.assert_array_equal(
                tbuckets.crop_from_bucket(padded[1], (h, w)), img)


@pytest.mark.parametrize("bad", [(), ((15, 24),), ((16, 24), (16, 24)),
                                 ((0, 8),)])
def test_buckets_refuse_alike(bad):
    got = [_outcome(lambda m=m: m[0].BucketPolicy(bad))[1]
           for m in PKGS.values()]
    assert got[0] is not None and got[0] == got[1]


# -- batcher ------------------------------------------------------------------

def _script_batcher(mod, **kw):
    """Submit a fixed mix (two buckets, two sessions, an expired request),
    pop every batch with timeout 0, then close with requests left. Returns
    the observable trace: batches as payload lists, errors by type."""
    expired = []
    b = mod.MicroBatcher(kw.get("max_batch", 2), 0.0, 16,
                         on_expired=lambda n, by: expired.append((n, by)))
    reqs = []
    plan = [("a", None), ("b", None), ("a", None), ("si", "s1"),
            ("si", "s2"), ("si", "s1"), ("a", None), ("si", "s1"),
            ("b", None)]
    for i, (key, sess) in enumerate(plan):
        r = mod.Request(key=key, payload=i, session=sess)
        b.submit(r)
        reqs.append(r)
    dead = mod.Request(key="a", payload="dead",
                       deadline=time.monotonic() - 1.0)
    b.submit(dead)
    out = []
    for _ in range(kw.get("pops", 4)):
        batch = b.next_batch(timeout=0.0)
        out.append([r.payload for r in batch])
    depth = b.depth
    rejected = b.close()
    after = b.next_batch(timeout=0.0)
    errors = [type(r.future.exception(timeout=0)).__name__
              if r.future.done() else None for r in reqs + [dead]]
    return out, depth, rejected, after, errors, expired


@pytest.mark.parametrize("max_batch,pops", [(1, 3), (2, 4), (3, 2), (4, 6)])
def test_batcher_sequences_affinity_deadlines_and_drain(max_batch, pops):
    got = [_script_batcher(m[1], max_batch=max_batch, pops=pops)
           for m in PKGS.values()]
    assert got[0] == got[1]
    batches = got[1][0]
    # session affinity: a batch never mixes two sessions
    sessions = {3: "s1", 4: "s2", 5: "s1", 7: "s1"}
    for batch in batches:
        assert len({sessions.get(p) for p in batch}) <= 1, batch


def test_batcher_overload_and_refusals_alike():
    got = []
    for m in PKGS.values():
        b = m[1].MicroBatcher(2, 0.0, 2)
        b.submit(m[1].Request(key="k", payload=0))
        b.submit(m[1].Request(key="k", payload=1))
        full = _outcome(lambda: b.submit(m[1].Request(key="k", payload=2)))
        b.close()
        closed = _outcome(lambda: b.submit(m[1].Request(key="k", payload=3)))
        got.append((full[1], closed[1],
                    _outcome(lambda: m[1].MicroBatcher(0, 1.0, 1))[1]))
    assert got[0] == got[1]
    assert got[1][0][0] == "ServiceOverloaded"
    assert got[1][1][0] == "ServiceDraining"
    assert got[1][2][0] == "ValueError"


# -- session store ------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _script_store(mods):
    _, _, session, metrics = mods[:4]
    clock = _Clock()
    reg = metrics.MetricsRegistry()
    store = session.SessionStore(max_sessions=3, max_bytes=100, ttl_s=5.0,
                                 metrics=reg, clock=clock)
    log = []

    def entry(sid, nbytes):
        return session.SessionEntry(sid=sid, prep=object(), bucket=(16, 24),
                                    nbytes=nbytes, digest="d")

    steps = [("put", "a", 30), ("put", "b", 30), ("get", "a"),
             ("put", "c", 30), ("put", "d", 30), ("get", "b"),
             ("tick", 3), ("get", "c"), ("tick", 3), ("get", "d"),
             ("put", "e", 80), ("put", "huge", 101), ("put", "c", 10),
             ("evict", "c"), ("evict", "zz"), ("tick", 6), ("get", "e"),
             ("put", "f", 20), ("clear",)]
    for step in steps:
        op = step[0]
        if op == "tick":
            clock.t += step[1]
            continue
        if op == "put":
            log.append(_outcome(lambda: store.put(entry(step[1], step[2]))))
        elif op == "get":
            log.append(_outcome(lambda: store.get(step[1]).sid))
        elif op == "evict":
            log.append(_outcome(lambda: store.evict(step[1], "closed")))
        else:
            log.append(_outcome(lambda: store.clear("drain")))
        log.append((store.live, store.bytes_used, sorted(store.snapshot())))
    snap = reg.snapshot()
    return log, snap["counters"], snap["gauges"]


def test_session_store_evictions_and_counters_alike():
    jax_log, tor_log = (_script_store(m) for m in PKGS.values())
    assert jax_log == tor_log
    counters = tor_log[1]
    for reason in ("lru", "bytes", "ttl", "closed", "drain"):
        assert counters[f"serve_session_evictions_{reason}"] >= 1, reason


# -- metrics ------------------------------------------------------------------

def _script_metrics(mod):
    reg = mod.MetricsRegistry()
    reg.counter("serve_submitted").inc(3)
    reg.counter("serve_completed").inc()
    reg.gauge("serve_queue_depth").set(2.5)
    reg.accumulator("serve_device_ms_total").add(1.25)
    for v in (3.0, 1.0, 2.0, 10.0, 0.5):
        reg.histogram("serve_latency_ms").observe(v)
    reg.histogram("serve_empty_ms")
    reg.set_info("serve_entropy_backend", {"backend": "thread", "n": 2})
    snap = reg.snapshot()
    text = [ln for ln in reg.render_text().splitlines()
            if not ln.startswith("lock_")]
    keep = ("info", "counters", "gauges", "histograms", "accumulators")
    return {k: snap[k] for k in keep}, text


def test_metrics_snapshot_and_text_alike():
    """The JAX text carries the ranked-lock ledgers (`lock_*` lines),
    which the port has not; everything else is equal."""
    (js, jt), (ts, tt) = (_script_metrics(m[3]) for m in PKGS.values())
    assert js == ts
    assert jt == tt
    assert "serve_latency_ms_p99 10" in tt


def test_metrics_server_answers(tmp_path):
    reg = tmetrics.MetricsRegistry()
    reg.counter("x").inc()
    srv = tmetrics.MetricsServer(reg, lambda: {"status": "ok"}, port=0,
                                 trace=lambda p: {"p": p}).start()
    try:
        from urllib.request import urlopen
        base = f"http://127.0.0.1:{srv.port}"
        assert urlopen(f"{base}/healthz", timeout=10).status == 200
        assert b"x_total 1" in urlopen(f"{base}/metrics", timeout=10).read()
        assert b'"p"' in urlopen(f"{base}/trace?id=3", timeout=10).read()
    finally:
        srv.stop()


# -- tracer -------------------------------------------------------------------

class _Req:
    def __init__(self, ctx):
        self.trace = ctx


def _norm_tid(tid):
    return tid.rsplit("-", 1)[1]


def _script_tracer(mod, rate):
    tr = mod.Tracer(sample_rate=rate, capacity=8)
    ctxs = [tr.mint() for _ in range(12)]
    reqs = [_Req(c) for c in ctxs]
    t0 = time.monotonic()
    tr.span_batch(reqs[:4], mod.SPAN_QUEUE, t0, t0 + 0.001, kind="encode")
    tr.span_batch(reqs[4:8], mod.SPAN_DEVICE, t0, t0 + 0.002, bucket=[16, 24])
    tr.span_batch(reqs[8:], mod.SPAN_ENTROPY, t0, t0 + 0.003)
    tr.error(ctxs[0], ValueError("bad"))
    snap = tr.snapshot()
    spans = [{"name": s["name"], "tids": [_norm_tid(t) for t in s["tids"]],
              "args": s.get("args")} for s in snap["spans"]]
    chrome = mod.chrome_trace(snap["spans"])["traceEvents"]
    events = [{"name": e["name"], "ph": e["ph"],
               "ids": [_norm_tid(t) for t in e["args"]["trace_ids"]],
               "args": {k: v for k, v in e["args"].items()
                        if k != "trace_ids"}} for e in chrome]
    counts = {k: snap[k] for k in ("recorded", "dropped", "capacity",
                                   "minted", "sampled", "sample_rate")}
    return [c.sampled for c in ctxs], spans, events, counts


@pytest.mark.parametrize("rate", [0.0, 0.25, 0.5, 1.0])
def test_tracer_sampling_spans_and_chrome_export_alike(rate):
    got = [_script_tracer(m[4], rate) for m in PKGS.values()]
    assert got[0] == got[1]
    assert got[1][3]["sampled"] == round(12 * rate)


def test_flight_recorder_rings_alike():
    got = []
    for m in PKGS.values():
        fr = m[4].FlightRecorder(capacity=4)
        for i in range(6):
            fr.record("admit", i=i)
        fr.note_error(ValueError("x"), trace_id="t")
        got.append([{k: v for k, v in e.items() if k != "t"}
                    for e in fr.snapshot()])
        fr.close()
    assert got[0] == got[1]


# -- retry and faults ---------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"base_delay_s": 0.01, "backoff": 3.0},
                                {"max_delay_s": 0.1, "backoff": 1.0},
                                {"max_attempts": 1}])
def test_retry_policy_delays_alike(kw):
    pols = [m[6].RetryPolicy(**kw) for m in PKGS.values()]
    for attempt in (0, 1, 2, 5, 63, 64, 70, 5000):
        assert pols[0].delay(attempt) == pols[1].delay(attempt)
    runs = []
    for m, pol in zip(PKGS.values(), pols):
        slept, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        runs.append((_outcome(lambda: m[6].call_with_retry(
            flaky, pol, retry_on=(OSError,), sleep=slept.append)),
            slept, len(calls)))
    assert runs[0] == runs[1]


def test_retry_policy_refuses_alike():
    for bad in ({"max_attempts": 0}, {"base_delay_s": -1},
                {"backoff": 0.5}):
        got = [_outcome(lambda m=m: m[6].RetryPolicy(**bad))[1]
               for m in PKGS.values()]
        assert got[0] is not None and got[0] == got[1]


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_fault_plan_fires_alike(seed):
    got = []
    for m in PKGS.values():
        f = m[5]
        plan = f.FaultPlan([
            f.FaultSpec("serve.rans", "corrupt", probability=0.5, flips=3),
            f.FaultSpec("serve.worker.batch", "raise", after=2, times=2),
            f.FaultSpec("serve.session", "crash", probability=0.3,
                        times=1)], seed=seed)
        out = []
        with f.installed(plan):
            for i in range(12):
                out.append(f.corrupt("serve.rans", bytes(range(i, i + 8))))
                out.append(_outcome(lambda: f.inject("serve.worker.batch")))
                try:
                    f.inject("serve.session")
                    out.append("pass")
                except f.InjectedCrash:
                    out.append("crash")
        assert f.active() is None
        got.append((out, [(a.site, a.action, a.visit) for a in plan.log],
                    dict(plan.visits), dict(plan.activations)))
    assert got[0] == got[1]


# -- DSRV framing ---------------------------------------------------------------

@pytest.mark.parametrize("shape,bucket,n", [((10, 17), (16, 24), 0),
                                            ((300, 1200), (320, 1224), 45),
                                            ((160, 600), (160, 600), 1000)])
def test_frames_byte_equal_and_parse_alike(shape, bucket, n):
    payload = bytes(np.random.default_rng(n).integers(0, 256, n,
                                                      dtype=np.uint8))
    frames = [m[7].frame_stream(payload, shape, bucket)
              for m in PKGS.values()]
    assert frames[0] == frames[1]
    for m in PKGS.values():
        assert m[7].parse_stream(frames[1]) == (payload, shape, bucket)
    # a v1 frame (no CRC) stays readable
    v1 = (b"DSRV" + np.array([1], np.uint8).tobytes()
          + np.array([*shape, *bucket], "<u2").tobytes()
          + np.array([n], "<u4").tobytes() + payload)
    for m in PKGS.values():
        assert m[7].parse_stream(v1) == (payload, shape, bucket)


def _corruptions(frame):
    flipped = bytearray(frame)
    flipped[-1 if len(frame) > 21 else 6] ^= 0x10
    liar = bytearray(frame)
    liar[5:7] = np.array([9999], "<u2").tobytes()
    return {"flipped": bytes(flipped), "short": frame[:10],
            "truncated": frame[:-1] if len(frame) > 21 else frame[:20],
            "magic": b"XSRV" + frame[4:], "version": frame[:4] + b"\x07"
            + frame[5:], "liar": bytes(liar)}


@pytest.mark.parametrize("kind", ["flipped", "short", "truncated", "magic",
                                  "version", "liar"])
def test_parse_stream_typed_errors_alike(kind):
    frame = tservice.frame_stream(b"\x01\x02\x03\x04", (10, 17), (16, 24))
    bad = _corruptions(frame)[kind]
    got = [_outcome(lambda m=m: m[7].parse_stream(bad))[1]
           for m in PKGS.values()]
    assert got[0] is not None and got[0] == got[1]
    assert got[1][0] in ("StreamCorrupt", "IntegrityError")


# -- launch counters under concurrent workers -----------------------------------

@pytest.mark.parametrize("module,name", [
    (sk, "pearson_argmax_shared"), (pk, "probclass_front_logits"),
    (ek, "fused_decode_epilogue")])
def test_launch_counters_lose_no_update(module, name):
    """Service workers count launches from several threads; more threads
    than cores and a short switch interval would lose an unguarded
    read-modify-write."""
    n_threads, n_each = 8, 2000
    interval = sys.getswitchinterval()
    module.reset_launch_counts()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [module._count_launch(name)
                            for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert module.launch_counts[name] == n_threads * n_each
    module.reset_launch_counts()
    assert module.launch_counts[name] == 0


def test_route_counter_loses_no_update():
    interval = sys.getswitchinterval()
    sf.reset_route_counts()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [sf._count_route("kernel") for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert sf.route_counts["kernel"] == 16000
    sf.reset_route_counts()


def test_copies_import_no_ranked_locks():
    for m in PKGS["torch"]:
        src = open(m.__file__).read()
        assert "locks_lib" not in src and not re.search(
            r"^from dsin_tpu\.", src, re.M), m.__name__
