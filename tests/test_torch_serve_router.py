"""The port's front door (dsin_tpu_torch/serve/router.py) on the CPU.

Most tests drive the router against FAKE replicas, in-process threads
speaking the port's pipe protocol through an injected launcher (the
JAX package's `_Fakes` of tests/test_serve_router.py and `_SessionFakes`
of tests/test_serve_session.py, merged), and mirror that file's tests:
admission, per-class routing, eviction and readmission, reroutes, the
fleet swap, session pinning, the aggregated metrics. No model is built.

The parity tests hold the port's rules exactly against the JAX package's:
the same admit / release / attach sequence through both
`AdmissionController`s, `default_admission_limits`, the protocol tuples,
and the metric and trace merges.
"""

import json
import multiprocessing
import threading
import time
import urllib.request

import numpy as np
import pytest

from dsin_tpu_torch.serve.batcher import (BULK, INTERACTIVE,
                                          DeadlineExceeded, Future,
                                          ServiceOverloaded,
                                          ServiceUnavailable,
                                          UnknownPriorityClass,
                                          default_priority_classes)
from dsin_tpu_torch.serve import metrics as metrics_lib
from dsin_tpu_torch.serve import protocol
from dsin_tpu_torch.serve import trace as trace_lib
from dsin_tpu_torch.serve.metrics import MetricsRegistry, MetricsServer
from dsin_tpu_torch.serve.router import (AdmissionController,
                                         FleetScaleError, FleetSwapError,
                                         FrontDoorRouter, _Pending,
                                         default_admission_limits)
from dsin_tpu_torch.serve.service import ServiceConfig
from dsin_tpu_torch.serve.session import SessionExpired
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


# -- admission control --------------------------------------------------------

def test_admission_validates_limits():
    with pytest.raises(ValueError):
        AdmissionController({})
    with pytest.raises(ValueError):
        AdmissionController({INTERACTIVE: 0})


def test_admission_unknown_class_is_typed():
    gate = AdmissionController({INTERACTIVE: 2})
    with pytest.raises(UnknownPriorityClass, match="unknown priority class"):
        gate.admit("vip")


def test_admission_sheds_at_capacity_with_class_and_depth():
    gate = AdmissionController({INTERACTIVE: 2, BULK: 1})
    gate.admit(INTERACTIVE)
    gate.admit(INTERACTIVE)
    with pytest.raises(ServiceOverloaded) as ei:
        gate.admit(INTERACTIVE)
    assert ei.value.priority == INTERACTIVE and ei.value.depth == 2
    assert "2/2" in str(ei.value) and "admission" in str(ei.value)
    gate.admit(BULK)                       # classes are independent
    assert gate.outstanding() == {INTERACTIVE: 2, BULK: 1}
    assert gate.metrics.counter(f"serve_admitted_{INTERACTIVE}").value == 2
    assert gate.metrics.counter(
        f"serve_shed_admission_{INTERACTIVE}").value == 1


def test_admission_attach_releases_on_any_resolution():
    gate = AdmissionController({INTERACTIVE: 1})
    gate.admit(INTERACTIVE)
    f = Future()
    gate.attach(INTERACTIVE, f)
    with pytest.raises(ServiceOverloaded):
        gate.admit(INTERACTIVE)            # still held
    f.set_exception(DeadlineExceeded("x", priority=INTERACTIVE))
    assert gate.outstanding() == {INTERACTIVE: 0}
    gate.admit(INTERACTIVE)                # freed by the resolution


@pytest.mark.parametrize("limits,match", [
    ({INTERACTIVE: 0, BULK: 3}, ">= 1"),
    ({INTERACTIVE: 3}, "fixed at construction")])
def test_admission_set_limits_refuses_typed(limits, match):
    gate = AdmissionController({INTERACTIVE: 1, BULK: 1})
    with pytest.raises(ValueError, match=match):
        gate.set_limits(limits)
    gate.set_limits({INTERACTIVE: 3, BULK: 2})
    assert gate.limits == {INTERACTIVE: 3, BULK: 2}


def test_default_admission_limits_counts_every_pipeline():
    cfg = ServiceConfig(ae_config="x", pc_config="y", max_queue=8,
                        max_batch=4, workers=2, pipeline_depth=3,
                        devices=2,
                        priority_classes=default_priority_classes(8))
    slack = 4 * 2 * 3 * 2
    assert default_admission_limits(cfg) == {INTERACTIVE: 8 + slack,
                                             BULK: 8 + slack}
    plain = ServiceConfig(ae_config="x", pc_config="y", max_queue=5,
                          max_batch=2, workers=1, pipeline_depth=1)
    assert default_admission_limits(plain) == {"default": 5 + 2}


# -- parity with the JAX package ----------------------------------------------

def _drive_gate(mod, future_cls, exc_types):
    """One scripted admit / attach / resolve / release / set_limits run;
    -> (decision log, outstanding, counters)."""
    gate = mod.AdmissionController({INTERACTIVE: 2, BULK: 1})
    log, futs = [], []
    script = [INTERACTIVE, BULK, BULK, INTERACTIVE, INTERACTIVE, "vip",
              "resolve", BULK, "release", INTERACTIVE, "grow", BULK, BULK]
    for step in script:
        if step == "resolve":
            futs.pop(0).set_result(None)
            log.append(("resolve", gate.outstanding()))
            continue
        if step == "release":
            gate.release(INTERACTIVE)
            log.append(("release", gate.outstanding()))
            continue
        if step == "grow":
            gate.set_limits({INTERACTIVE: 2, BULK: 3})
            log.append(("grow", dict(gate.limits)))
            continue
        try:
            gate.admit(step)
        except exc_types as e:
            log.append((step, type(e).__name__, getattr(e, "priority", None),
                        getattr(e, "depth", None), str(e)))
            continue
        f = future_cls()
        gate.attach(step, f)
        futs.append(f)
        log.append((step, "admitted"))
    counters = gate.metrics.snapshot()["counters"]
    return log, gate.outstanding(), counters


def test_admission_decisions_equal_jax():
    from dsin_tpu.serve import batcher as jax_batcher
    from dsin_tpu.serve import router as jax_router
    from dsin_tpu_torch.serve import batcher as port_batcher
    from dsin_tpu_torch.serve import router as port_router
    want = _drive_gate(jax_router, jax_batcher.Future,
                       (jax_batcher.ServeError,))
    got = _drive_gate(port_router, port_batcher.Future,
                      (port_batcher.ServeError,))
    assert got == want
    assert any(entry[1] == "ServiceOverloaded" for entry in got[0])
    assert any(entry[1] == "UnknownPriorityClass" for entry in got[0])


@pytest.mark.parametrize("fields", [
    dict(max_queue=8, max_batch=4, workers=2, pipeline_depth=3, devices=2,
         classes=True),
    dict(max_queue=5, max_batch=2, workers=1, pipeline_depth=1,
         classes=False),
    dict(max_queue=64, max_batch=4, workers=1, pipeline_depth=2,
         classes=True, deadline=30000.0)])
def test_default_admission_limits_equal_jax(fields):
    from dsin_tpu.serve import batcher as jax_batcher
    from dsin_tpu.serve import router as jax_router
    from dsin_tpu.serve.service import ServiceConfig as JaxConfig
    kw = dict(ae_config="x", pc_config="y", max_queue=fields["max_queue"],
              max_batch=fields["max_batch"], workers=fields["workers"],
              pipeline_depth=fields["pipeline_depth"],
              devices=fields.get("devices"))
    dl = fields.get("deadline")
    port_kw, jax_kw = dict(kw), dict(kw)
    if fields["classes"]:
        port_kw["priority_classes"] = default_priority_classes(
            fields["max_queue"], bulk_deadline_ms=dl)
        jax_kw["priority_classes"] = jax_batcher.default_priority_classes(
            fields["max_queue"], bulk_deadline_ms=dl)
    assert default_admission_limits(ServiceConfig(**port_kw)) == \
        jax_router.default_admission_limits(JaxConfig(**jax_kw))


def test_protocol_tuples_equal_jax():
    from dsin_tpu.serve import protocol as jax_protocol
    ctx = trace_lib.TraceContext("abc-1", True)
    assert protocol.stop_msg() == jax_protocol.stop_msg()
    assert protocol.control_msg("swap_commit", 7, "d1") == \
        jax_protocol.control_msg("swap_commit", 7, "d1")
    req = protocol.request_msg("encode", 3, b"x", BULK, 12.5, ctx)
    assert req == jax_protocol.request_msg("encode", 3, b"x", BULK, 12.5,
                                           ctx)
    for msg in (req, protocol.control_msg("rollback", 9, None),
                protocol.stop_msg()):
        assert protocol.parse_request(msg) == \
            jax_protocol.parse_request(msg)
    assert (protocol.CONTROL_OPS, protocol.REQUEST_OPS,
            protocol.SESSION_OPS, protocol.STOP) == \
        (jax_protocol.CONTROL_OPS, jax_protocol.REQUEST_OPS,
         jax_protocol.SESSION_OPS, jax_protocol.STOP)
    assert protocol.wire_payload(None, b"blob") == \
        jax_protocol.wire_payload(None, b"blob") == b"blob"


def _snaps(seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(3):
        reg = MetricsRegistry()
        reg.counter("serve_completed").inc(int(rng.integers(1, 50)))
        reg.gauge("serve_queue_depth").set(float(rng.integers(0, 9)))
        reg.accumulator("serve_device_ms_total").add(float(rng.random()))
        for v in rng.exponential(40.0, size=5 + 3 * k):
            reg.histogram("serve_latency_ms").observe(float(v))
        if k:
            reg.histogram(f"serve_latency_ms_{BULK}").observe(float(k))
        out.append(reg.snapshot())
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_metric_merges_equal_jax(seed):
    from dsin_tpu.serve import metrics as jax_metrics
    own, *replicas = _snaps(seed)
    results = []
    for mod in (metrics_lib, jax_metrics):
        counters, gauges, acc = (dict(own["counters"]), dict(own["gauges"]),
                                 dict(own["accumulators"]))
        hist = mod.hist_partials(own["histograms"])
        for snap in replicas:
            mod.merge_numeric_sections(counters, gauges, acc, hist, snap)
        results.append((counters, gauges, acc, mod.fold_hist_partials(hist)))
    assert results[0] == results[1]
    assert results[0][3]["serve_latency_ms"]["count"] == 5 + 8 + 11


def test_trace_merge_equal_jax():
    from dsin_tpu.serve import trace as jax_trace
    parts = []
    for k in range(3):
        tracer = trace_lib.Tracer(sample_rate=1.0)
        for i in range(4):
            ctx = tracer.mint(origin=f"p{k}")
            t0 = time.monotonic() - 0.01 * (i + k)
            tracer.span_for(ctx, trace_lib.SPAN_ROUTER, t0, t0 + 0.001,
                            op="encode")
        parts.append(tracer.snapshot())
    got = trace_lib.merge_trace_snapshots(parts)
    assert got == jax_trace.merge_trace_snapshots(parts)
    assert [s["ts"] for s in got] == sorted(s["ts"] for s in got)
    assert len(got) == 12
    ctx = trace_lib.TraceContext("t-9", False)
    assert trace_lib.echo_context(ctx) == jax_trace.echo_context(ctx) == ctx


# -- fake replicas --------------------------------------------------------------

class _Fakes:
    """Injected launcher: each replica is an in-process thread speaking
    the port's pipe protocol (requests, swap control, session ops). The
    test keeps the per-replica controls: received requests, kill switches,
    what each replica answers at prepare and whether a phase fails."""

    def __init__(self, n, digests=None, health_ports=None):
        self.n = n
        self.digests = digests or ["d0"] * n
        self.health_ports = health_ports or [None] * n
        self.received = {i: [] for i in range(n)}
        self.deadlines = {i: [] for i in range(n)}
        self.got_request = {i: threading.Event() for i in range(n)}
        self.respond = {i: True for i in range(n)}
        self.dead = {i: threading.Event() for i in range(n)}
        self.threads = {}
        self.prepare_digests = {i: "dnew" for i in range(n)}
        self.fail_prepare = {i: None for i in range(n)}
        self.fail_commit = {i: None for i in range(n)}
        self.hang_prepare = {i: False for i in range(n)}
        self.got_prepare = {i: threading.Event() for i in range(n)}
        self.committed = {i: [] for i in range(n)}
        self.aborted = {i: 0 for i in range(n)}
        self.rolled_back = {i: 0 for i in range(n)}
        self.opened = {i: [] for i in range(n)}
        self.decoded = {i: [] for i in range(n)}
        self.closed = {i: [] for i in range(n)}

    def launcher(self, config, idx, ctx):
        parent, child = multiprocessing.Pipe(duplex=True)
        for table in (self.received, self.deadlines, self.committed,
                      self.opened, self.decoded, self.closed):
            table.setdefault(idx, [])
        for table, v in ((self.respond, True), (self.aborted, 0),
                         (self.rolled_back, 0), (self.fail_prepare, None),
                         (self.fail_commit, None), (self.hang_prepare, False),
                         (self.prepare_digests, "dnew")):
            table.setdefault(idx, v)
        for table in (self.got_request, self.dead, self.got_prepare):
            table.setdefault(idx, threading.Event())
        if idx >= len(self.digests):
            self.digests.append(self.digests[0])
            self.health_ports.append(None)
        t = threading.Thread(target=self._run, args=(idx, child),
                             name=f"fake-replica-{idx}", daemon=True)
        self.threads[idx] = t
        t.start()
        return None, parent

    def _run(self, idx, conn):
        conn.send(("ready", idx, {
            "replica": idx, "pid": 0, "healthz_port": self.health_ports[idx],
            "params_digest": self.digests[idx]}))
        n_sids = 0
        # a poll loop (never parked inside recv): kill() closes the pipe
        # from this thread and the router's reader sees a clean EOF, as
        # after a process crash
        while not self.dead[idx].is_set():
            try:
                if not conn.poll(0.02):
                    continue
                msg = conn.recv()
            except (EOFError, OSError):
                return
            if msg[0] == protocol.STOP:
                try:
                    conn.send(("bye", idx, None))
                    conn.close()
                except OSError:
                    pass
                return
            op, rid, payload, priority, deadline_ms, _trace = \
                protocol.parse_request(msg)
            if op == "swap_prepare":
                self.got_prepare[idx].set()
                if self.hang_prepare[idx]:
                    continue
                if self.fail_prepare[idx] is not None:
                    conn.send(("err", rid, self.fail_prepare[idx]))
                else:
                    conn.send(("ok", rid, {"digest": self.prepare_digests[idx],
                                           "epoch": 1, "ckpt": payload}))
                continue
            if op == "swap_commit":
                if self.fail_commit[idx] is not None:
                    conn.send(("err", rid, self.fail_commit[idx]))
                else:
                    self.committed[idx].append(payload)
                    conn.send(("ok", rid, {"digest": payload}))
                continue
            if op == "swap_abort":
                self.aborted[idx] += 1
                conn.send(("ok", rid, {"swap_state": 0}))
                continue
            if op == "rollback":
                self.rolled_back[idx] += 1
                conn.send(("ok", rid, {"digest": self.digests[idx]}))
                continue
            if op == "session_open":
                n_sids += 1
                sid = f"r{idx}-s{n_sids}"
                self.opened[idx].append(sid)
                conn.send(("ok", rid, sid))
                continue
            if op == "session_close":
                self.closed[idx].append(payload)
                conn.send(("ok", rid, True))
                continue
            if op == "decode_si":
                self.decoded[idx].append(payload[1])
                conn.send(("ok", rid, ("img", idx, payload[1])))
                continue
            self.received[idx].append((op, rid, priority))
            self.deadlines[idx].append(deadline_ms)
            self.got_request[idx].set()
            if self.respond[idx]:
                conn.send(("ok", rid, ("echo", idx, op, priority)))
        conn.close()

    def kill(self, idx):
        """Replica death: the fake closes its own pipe end on its own
        thread; the router's reader sees EOF as after a crash."""
        self.dead[idx].set()
        self.threads[idx].join(timeout=5)


def _router(fakes, replicas=2, **kw):
    cfg = ServiceConfig(ae_config="unused", pc_config="unused", max_queue=8,
                        priority_classes=default_priority_classes(8))
    kw.setdefault("poll_every_s", 5.0)   # polling quiet unless asked
    return FrontDoorRouter(cfg, replicas=replicas, launcher=fakes.launcher,
                           **kw)


def _wait_state(r, idx, state, timeout=5.0):
    deadline = time.monotonic() + timeout
    while r.health()["replicas"][str(idx)] != state:
        assert time.monotonic() < deadline, r.health()
        time.sleep(0.02)


def test_router_round_robins_per_class_across_live_replicas():
    fakes = _Fakes(2)
    r = _router(fakes).start()
    try:
        results = [r.encode(f"img{i}", timeout=5) for i in range(4)]
        assert [res[1] for res in results] == [0, 1, 0, 1]
        # bulk has its OWN rr cursor, starting at replica 0 again
        assert r.decode(b"blob", priority=BULK, timeout=5) == \
            ("echo", 0, "decode", BULK)
        assert r.metrics.counter("serve_router_routed_r0").value == 3
        assert r.metrics.counter(
            f"serve_router_routed_{INTERACTIVE}").value == 4
        assert r.metrics.counter(f"serve_router_routed_{BULK}").value == 1
        assert r.params_digest == "d0"
    finally:
        r.drain(timeout_s=5)


def test_router_refuses_mismatched_replica_digests():
    r = _router(_Fakes(2, digests=["aaaa", "bbbb"]))
    with pytest.raises(RuntimeError, match="DIFFERENT models"):
        r.start()


def test_router_admission_sheds_before_any_dispatch():
    fakes = _Fakes(1)
    r = _router(fakes, replicas=1,
                admission_limits={INTERACTIVE: 1, BULK: 1}).start()
    try:
        fakes.respond[0] = False          # park one request in flight
        f1 = r.submit_encode("img")
        with pytest.raises(ServiceOverloaded) as ei:
            r.submit_encode("img2")
        assert ei.value.priority == INTERACTIVE
        fakes.got_request[0].wait(2)
        assert len(fakes.received[0]) == 1    # nothing shipped for the shed
        assert not f1.done()
    finally:
        r.drain(timeout_s=5)
        assert isinstance(f1.exception(timeout=1), ServiceUnavailable)


def test_replica_death_reroutes_inflight_without_failing_caller():
    fakes = _Fakes(2)
    r = _router(fakes).start()
    try:
        fakes.respond[0] = False
        fut = r.submit_encode("img")              # rr -> replica 0
        assert fakes.got_request[0].wait(2)
        assert not fut.done()
        fakes.kill(0)                             # dies holding the request
        assert fut.result(timeout=5)[1] == 1      # answered by replica 1
        assert r.metrics.counter("serve_router_reroutes").value == 1
        assert r.metrics.counter("serve_router_replica_deaths").value == 1
        assert r.health()["replicas"]["0"] == "dead"
        assert r.health()["status"] == "degraded"
    finally:
        r.drain(timeout_s=5)


def test_reroute_forwards_remaining_deadline_budget():
    fakes = _Fakes(2)
    r = _router(fakes).start()
    try:
        fakes.respond[0] = False
        fut = r.submit_encode("img", deadline_ms=10_000.0)
        assert fakes.got_request[0].wait(2)
        first = fakes.deadlines[0][0]
        assert first is not None and first <= 10_000.0
        time.sleep(0.05)
        fakes.kill(0)
        assert fut.result(timeout=5)[1] == 1
        assert fakes.deadlines[1][0] < first - 25.0
    finally:
        r.drain(timeout_s=5)


def test_reroute_of_expired_request_fails_typed_not_zombie():
    fakes = _Fakes(2)
    r = _router(fakes).start()
    try:
        fakes.respond[0] = False
        fut = r.submit_encode("img", deadline_ms=40.0)
        assert fakes.got_request[0].wait(2)
        time.sleep(0.1)                           # burn the whole budget
        fakes.kill(0)
        exc = fut.exception(timeout=5)
        assert isinstance(exc, DeadlineExceeded)
        assert exc.priority == INTERACTIVE
        assert r.metrics.counter("serve_router_reroutes").value == 0
        assert r.metrics.counter(
            f"serve_router_expired_{INTERACTIVE}").value == 1
        assert not fakes.received[1]
    finally:
        r.drain(timeout_s=5)


def test_replica_death_with_no_survivor_fails_typed():
    fakes = _Fakes(1)
    r = _router(fakes, replicas=1).start()
    try:
        fakes.respond[0] = False
        fut = r.submit_encode("img")
        assert fakes.got_request[0].wait(2)
        fakes.kill(0)
        assert isinstance(fut.exception(timeout=5), ServiceUnavailable)
        with pytest.raises(ServiceUnavailable):
            r.submit_encode("img2")               # the door fails fast
        assert r.health()["status"] == "unhealthy"
    finally:
        r.drain(timeout_s=5)


class _HookedLock:
    """A replica lock that parks one named thread before it acquires, so a
    death can win the race against that thread's dispatch (the JAX test
    does this with the ranked locks' acquire hook)."""

    def __init__(self, lock, thread_name, parked, release):
        self._lock = lock
        self._name = thread_name
        self._parked = parked
        self._release = release

    def __enter__(self):
        if threading.current_thread().name == self._name:
            self._parked.set()
            self._release.wait(5)
        return self._lock.__enter__()

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)


def test_eviction_wins_race_against_dispatch_future_resolves_once():
    fakes = _Fakes(2)
    r = _router(fakes).start()
    try:
        rep0 = r._replicas[0]
        parked, release = threading.Event(), threading.Event()
        rep0.lock = _HookedLock(rep0.lock, "submitter", parked, release)
        out = {}
        t = threading.Thread(
            target=lambda: out.__setitem__("res", r.encode("img",
                                                           timeout=10)),
            name="submitter")
        t.start()
        assert parked.wait(5)          # picked replica 0, about to send
        fakes.kill(0)                  # the death handler wins the race
        _wait_state(r, 0, "dead")
        release.set()                  # the send hits a dead pipe
        t.join(10)
        assert not t.is_alive()
        assert out["res"][1] == 1      # exactly one resolution: survivor
        assert all(r.encode(f"img{i}", timeout=5)[1] == 1 for i in range(2))
    finally:
        r.drain(timeout_s=5)


def test_healthz_eviction_and_readmission():
    state = {"status": "ok"}
    server = MetricsServer(MetricsRegistry(), lambda: dict(state),
                           port=0).start()
    try:
        fakes = _Fakes(2, health_ports=[server.port, None])
        r = _router(fakes, poll_every_s=0.05, evict_after=2,
                    health_timeout_s=1.0).start()
        try:
            state["status"] = "unhealthy"          # /healthz -> 503
            _wait_state(r, 0, "evicted")
            assert [r.encode(f"i{k}", timeout=5)[1]
                    for k in range(3)] == [1, 1, 1]
            assert r.metrics.counter("serve_router_evictions").value == 1
            state["status"] = "ok"
            _wait_state(r, 0, "live")
            assert r.metrics.counter("serve_router_readmissions").value == 1
            assert {r.encode(f"j{k}", timeout=5)[1]
                    for k in range(2)} == {0, 1}
        finally:
            r.drain(timeout_s=5)
    finally:
        server.stop()


def test_readmission_refused_while_digest_disagrees_with_fleet():
    state = {"status": "ok", "model": {"digest": "dold"}}
    server = MetricsServer(MetricsRegistry(), lambda: dict(state),
                           port=0).start()
    try:
        fakes = _Fakes(2, health_ports=[server.port, None])
        r = _router(fakes, poll_every_s=0.05, evict_after=2,
                    health_timeout_s=1.0).start()
        try:
            r.params_digest = "dold"
            state["status"] = "unhealthy"
            _wait_state(r, 0, "evicted")
            r.params_digest = "dnew"              # the fleet swapped
            state["status"] = "ok"                # healthy, OLD model
            deadline = time.monotonic() + 2
            while r.metrics.counter("serve_router_digest_skew").value == 0:
                assert time.monotonic() < deadline
                time.sleep(0.02)
            assert r.health()["replicas"]["0"] == "evicted"
            state["model"] = {"digest": "dnew"}
            _wait_state(r, 0, "live")
        finally:
            r.drain(timeout_s=5)
    finally:
        server.stop()


# -- the fleet's two-phase swap -------------------------------------------------

def _run_swap(router, ckpt):
    try:
        return {"res": router.swap_model(ckpt), "exc": None}
    except BaseException as e:  # noqa: BLE001 — the test inspects it
        return {"res": None, "exc": e}


def test_fleet_swap_commits_only_on_unanimous_digest():
    fakes = _Fakes(2)
    r = _router(fakes).start()
    try:
        out = r.swap_model("/ckpt/new")
        assert out["digest"] == "dnew" and out["replicas"] == [0, 1]
        assert fakes.committed == {0: ["dnew"], 1: ["dnew"]}
        assert fakes.aborted == {0: 0, 1: 0}
        assert r.params_digest == "dnew"
        assert r.metrics.counter("serve_router_swaps").value == 1
        assert r.encode("img", timeout=5)[1] in (0, 1)
    finally:
        r.drain(timeout_s=5)


@pytest.mark.parametrize("fault", ["disagree", "refuse", "die"])
def test_fleet_prepare_failure_aborts_whole_fleet(fault):
    """A split digest, one replica's typed refusal, or a replica dying in
    its prepare: nothing commits, every replica aborts, the old model
    keeps serving."""
    from dsin_tpu_torch.train.checkpoint import ManifestMismatch
    fakes = _Fakes(2)
    if fault == "disagree":
        fakes.prepare_digests = {0: "aaaa", 1: "bbbb"}
    elif fault == "refuse":
        fakes.fail_prepare[1] = ManifestMismatch("pc hash mismatch")
    else:
        fakes.hang_prepare[0] = True
    r = _router(fakes).start()
    try:
        if fault == "die":
            out = {}
            t = threading.Thread(target=lambda: out.update(
                _run_swap(r, "/ckpt/new")))
            t.start()
            assert fakes.got_prepare[0].wait(5)
            fakes.kill(0)                  # dies holding its prepare
            t.join(10)
            assert not t.is_alive()
            exc = out["exc"]
            assert isinstance(exc.per_replica[0], ServiceUnavailable)
            assert r.encode("img", timeout=5)[1] == 1
        else:
            with pytest.raises(FleetSwapError,
                               match="did not converge") as ei:
                r.swap_model("/ckpt/new")
            exc = ei.value
            assert fakes.aborted[0] == 1
            if fault == "refuse":
                assert isinstance(exc.per_replica[1], ManifestMismatch)
        assert isinstance(exc, FleetSwapError)
        assert fakes.committed[1] == [] and fakes.aborted[1] == 1
        assert r.params_digest == "d0"
        assert r.metrics.counter("serve_router_swap_aborts").value == 1
    finally:
        r.drain(timeout_s=5)


def test_fleet_commit_failure_rolls_back_committed_replicas():
    fakes = _Fakes(2)
    fakes.fail_commit[1] = RuntimeError("commit wedged")
    r = _router(fakes).start()
    try:
        with pytest.raises(FleetSwapError, match="rolled back"):
            r.swap_model("/ckpt/new")
        assert fakes.committed[0] == ["dnew"]
        assert fakes.rolled_back[0] == 1
        assert fakes.aborted[1] == 1
        assert r.params_digest == "d0"
    finally:
        r.drain(timeout_s=5)


def test_fleet_rollback_fans_out_and_reports_digest():
    fakes = _Fakes(2)
    r = _router(fakes).start()
    try:
        out = r.rollback()
        assert out["digest"] == "d0" and out["replicas"] == [0, 1]
        assert fakes.rolled_back == {0: 1, 1: 1}
        assert r.metrics.counter("serve_router_rollbacks").value == 1
    finally:
        r.drain(timeout_s=5)


def test_concurrent_fleet_swaps_refused_typed():
    fakes = _Fakes(1)
    fakes.hang_prepare[0] = True
    r = _router(fakes, replicas=1).start()
    try:
        out = {}
        t = threading.Thread(target=lambda: out.update(
            _run_swap(r, "/ckpt/new")))
        t.start()
        assert fakes.got_prepare[0].wait(5)
        with pytest.raises(FleetSwapError, match="already in flight"):
            r.swap_model("/ckpt/other")
        with pytest.raises(FleetScaleError, match="fleet swap"):
            r.add_replica()
        fakes.kill(0)                # release the hung prepare
        t.join(10)
    finally:
        r.drain(timeout_s=5)


# -- session pinning ------------------------------------------------------------

def test_router_pins_sessions_and_routes_affine():
    fakes = _Fakes(2)
    r = _router(fakes).start()
    try:
        s_a = r.open_session(np.zeros((4, 4, 3)))     # rr -> replica 0
        s_b = r.open_session(np.zeros((4, 4, 3)))     # rr -> replica 1
        assert s_a.startswith("r0") and s_b.startswith("r1")
        for _ in range(3):
            assert r.decode_si(b"blob", s_a)[1] == 0
        assert r.decode_si(b"blob", s_b)[1] == 1
        assert fakes.decoded[0] == [s_a] * 3 and fakes.decoded[1] == [s_b]
        assert r.metrics.gauge("serve_router_sessions_pinned").value == 2
        assert r.close_session(s_a) is True
        assert fakes.closed[0] == [s_a]
        with pytest.raises(SessionExpired):
            r.submit_decode_si(b"blob", s_a)
    finally:
        r.drain()


def test_router_replica_death_expires_its_sessions_typed():
    fakes = _Fakes(2)
    r = _router(fakes).start()
    try:
        s_a = r.open_session(np.zeros((4, 4, 3)))     # replica 0
        s_b = r.open_session(np.zeros((4, 4, 3)))     # replica 1
        fakes.kill(0)
        _wait_state(r, 0, "dead")
        with pytest.raises(SessionExpired, match="re-open"):
            r.submit_decode_si(b"blob", s_a)
        assert r.metrics.counter("serve_router_session_orphans").value == 1
        assert r.decode_si(b"blob", s_b)[1] == 1
        s_c = r.open_session(np.zeros((4, 4, 3)))
        assert s_c.startswith("r1") and r.decode_si(b"blob", s_c)[1] == 1
    finally:
        r.drain()


def test_router_death_midflight_si_futures_resolve_typed_once():
    fakes = _Fakes(2)
    r = _router(fakes).start()
    try:
        s_a = r.open_session(np.zeros((4, 4, 3)))
        rep = r._replicas[0]
        pending = _Pending("decode_si", (b"blob", s_a), INTERACTIVE, None, 0)
        with rep.lock:
            rep.inflight[999999] = pending
        fakes.kill(0)
        assert isinstance(pending.future.exception(timeout=5),
                          SessionExpired)
    finally:
        r.drain()


def test_fleet_swap_drops_every_pin():
    fakes = _Fakes(2)
    r = _router(fakes).start()
    try:
        sid = r.open_session(np.zeros((4, 4, 3)))
        r.swap_model("/ckpt/new")
        with pytest.raises(SessionExpired):
            r.submit_decode_si(b"blob", sid)
        assert r.metrics.counter(
            "serve_router_sessions_dropped_swap").value == 1
    finally:
        r.drain()


# -- the elastic half -----------------------------------------------------------

def test_add_replica_admits_after_handshake_and_drain_replica_leaves():
    fakes = _Fakes(1)
    r = _router(fakes, replicas=1).start()
    try:
        info = r.add_replica()
        assert info["replica"] == 1 and r.health()["live"] == 2
        assert {r.encode(f"i{k}", timeout=5)[1] for k in range(2)} == {0, 1}
        # the aggregate admission cap follows the live fleet
        per = default_admission_limits(r.config)
        assert r.admission.limits == {c: 2 * n for c, n in per.items()}
        sid = r.open_session(np.zeros((4, 4, 3)))     # replica 0 ...
        out = r.drain_replica(idx=int(sid[1]))
        assert out["replica"] == int(sid[1])
        assert r.health()["status"] == "ok"           # a drain is no fault
        with pytest.raises(SessionExpired):
            r.submit_decode_si(b"blob", sid)
        with pytest.raises(FleetScaleError, match="last live replica"):
            r.drain_replica()
        assert r.metrics.counter("serve_router_scale_downs").value == 1
        assert r.admission.limits == per
    finally:
        r.drain(timeout_s=5)


def test_add_replica_refuses_a_different_model():
    fakes = _Fakes(1)
    r = _router(fakes, replicas=1).start()
    try:
        fakes.digests.append("other")
        fakes.health_ports.append(None)
        with pytest.raises(FleetScaleError, match="built model"):
            r.add_replica()
        assert r.health()["live"] == 1
        assert r.metrics.counter("serve_router_digest_skew").value == 1
    finally:
        r.drain(timeout_s=5)


def test_prewarmed_template_is_admitted_on_add():
    fakes = _Fakes(1)
    r = _router(fakes, replicas=1, prewarm_template=True).start()
    try:
        deadline = time.monotonic() + 5
        while not r.template_ready():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        info = r.add_replica()
        assert info["template_admit"] is True
        assert r.metrics.counter("serve_template_admits").value == 1
        assert {r.encode(f"i{k}", timeout=5)[1] for k in range(2)} == {0, 1}
    finally:
        r.drain(timeout_s=5)


# -- the fleet's metrics and traces ---------------------------------------------

def test_aggregated_metrics_merges_replica_snapshots():
    regs = [MetricsRegistry(), MetricsRegistry()]
    servers = []
    for i, reg in enumerate(regs):
        reg.counter("serve_completed").inc(10 * (i + 1))
        reg.gauge("serve_queue_depth").set(3 * (i + 1))
        reg.accumulator("serve_device_ms_total").add(100.0 * (i + 1))
        for v in ([5.0] * 4 if i == 0 else [50.0] * 6):
            reg.histogram("serve_latency_ms").observe(v)
        reg.set_info("serve_model_digest", {"digest": f"m{i}", "epoch": i})
        servers.append(MetricsServer(reg, lambda: {"status": "ok"},
                                     port=0).start())
    try:
        fakes = _Fakes(2, health_ports=[s.port for s in servers])
        r = _router(fakes).start()
        try:
            r.metrics.counter("serve_completed").inc(1)  # the router's own
            snap = r.aggregate.snapshot()
            assert snap["counters"]["serve_completed"] == 31
            assert snap["gauges"]["serve_queue_depth"] == 9.0
            assert snap["accumulators"]["serve_device_ms_total"] == 300.0
            lat = snap["histograms"]["serve_latency_ms"]
            assert lat["count"] == 10
            assert lat["mean"] == pytest.approx((4 * 5 + 6 * 50) / 10)
            assert lat["p99"] == 50.0
            info = snap["info"]
            assert info["replica_digests"] == {"0": "m0", "1": "m1"}
            assert info["replicas_scraped"] == 2
            assert info["replicas_unreachable"] == []
            text = r.aggregate.render_text()
            assert "serve_completed_total 31" in text
            assert "# replica_digests" in text
        finally:
            r.drain(timeout_s=5)
    finally:
        for s in servers:
            s.stop()


def test_aggregated_metrics_served_over_http_and_survives_dead_scrape():
    reg = MetricsRegistry()
    reg.counter("serve_completed").inc(5)
    server = MetricsServer(reg, lambda: {"status": "ok"}, port=0).start()
    try:
        fakes = _Fakes(2, health_ports=[server.port, 1])
        r = _router(fakes, metrics_port=0).start()
        try:
            port = r._metrics_server.port
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics?format=json",
                    timeout=5) as resp:
                snap = json.loads(resp.read())
            assert snap["counters"]["serve_completed"] == 5
            assert snap["info"]["replicas_unreachable"] == [1]
            assert snap["info"]["replicas_scraped"] == 1
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as resp:
                assert resp.status == 200
        finally:
            r.drain(timeout_s=5)
    finally:
        server.stop()


def test_aggregated_metrics_excludes_a_frozen_replica():
    """A scrape whose seq did not advance is stale: flagged and kept out
    of the merge."""
    frozen = MetricsRegistry()
    frozen.counter("serve_completed").inc(7)
    snap = frozen.snapshot()

    class _Frozen(MetricsRegistry):
        def snapshot(self):
            return dict(snap)

    server = MetricsServer(_Frozen(), lambda: {"status": "ok"},
                           port=0).start()
    try:
        fakes = _Fakes(1, health_ports=[server.port])
        r = _router(fakes, replicas=1).start()
        try:
            assert r.aggregate.snapshot()["counters"]["serve_completed"] == 7
            again = r.aggregate.snapshot()
            assert again["info"]["replicas_stale"] == [0]
            assert "serve_completed" not in again["counters"]
        finally:
            r.drain(timeout_s=5)
    finally:
        server.stop()


def test_router_dispatch_span_and_fleet_trace():
    fakes = _Fakes(2)
    r = _router(fakes, trace_sample_rate=1.0).start()
    try:
        fut = r.submit_encode("img")
        fut.result(5)
        tid = fut.trace.trace_id
        snap = r.traces.snapshot(trace_id=tid)
        assert [s["name"] for s in snap["spans"]] == [trace_lib.SPAN_ROUTER]
        assert snap["router_spans"] == 1 and snap["replicas_scraped"] == 0
    finally:
        r.drain(timeout_s=5)
