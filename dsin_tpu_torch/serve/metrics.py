"""Lock-guarded service metrics + stdlib health/metrics HTTP endpoint (a
copy of the JAX package's `serve/metrics.py`, with the fleet merge helpers
its router's `AggregatedMetrics` folds replica snapshots through).

Everything an operator needs to answer "is the service keeping up":
queue depth, batch occupancy (how full the micro-batches actually run —
low occupancy at high load means max_wait_ms is mis-tuned), request
latency quantiles, rejection counters split by cause, and the native
build count (`native_build.build_count()`: any motion after warmup means
a kernel was built on the request path).

No prometheus client dependency: counters/gauges/histograms are tiny
lock-guarded classes and the endpoint is `http.server` — the text format
is prometheus-compatible enough (`name value` lines) to scrape, and
`/healthz` + `/metrics?format=json` serve humans and tests. A
`threading.Lock` stands where the JAX package uses its ranked locks, so
the snapshot carries no lock ledger.

Latency quantiles come from a bounded reservoir (last `maxlen` samples)
— exact percentiles over an unbounded run would grow memory, and a
sliding window is the operationally useful view anyway.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Mapping, Optional
from urllib.parse import parse_qs, urlparse



class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0                    # guarded-by: self._lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0                  # guarded-by: self._lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Accumulator:
    """Lock-guarded float total — a Counter for non-integer quantities
    (stage milliseconds, bytes). The pipelined dataplane keeps its
    device/entropy/busy wall-time sums here so `serve_overlap_ratio`
    can be recomputed from the snapshot alone."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0                  # guarded-by: self._lock

    def add(self, v: float) -> None:
        with self._lock:
            self._value += float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Bounded-reservoir summary: count/mean (and all-time min/max)
    over everything ever observed, quantiles over the most recent
    `maxlen` samples: a p99 over a sliding reservoir forgets the one
    catastrophic sample an operator needs to see, the all-time max
    keeps it."""

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=maxlen)  # guarded-by: self._lock
        self._count = 0                    # guarded-by: self._lock
        self._sum = 0.0                    # guarded-by: self._lock
        self._min = float("inf")           # guarded-by: self._lock
        self._max = float("-inf")          # guarded-by: self._lock

    def observe(self, v: float) -> None:
        with self._lock:
            self._window.append(float(v))
            self._count += 1
            self._sum += float(v)
            if v < self._min:
                self._min = float(v)
            if v > self._max:
                self._max = float(v)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the window; 0.0 when empty."""
        with self._lock:
            if not self._window:
                return 0.0
            xs = sorted(self._window)
        rank = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
        return xs[rank]

    def summary(self) -> Dict[str, float]:
        with self._lock:
            count, total = self._count, self._sum
            vmin, vmax = self._min, self._max
        return {
            "count": count,
            "mean": (total / count) if count else 0.0,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
            "min": vmin if count else 0.0,
            "max": vmax if count else 0.0,
        }


class MetricsRegistry:
    """Named metric namespace; creation is idempotent so call sites just
    `registry.counter('x').inc()` without wiring declarations around."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}          # guarded-by: self._lock
        self._gauges: Dict[str, Gauge] = {}              # guarded-by: self._lock
        self._histograms: Dict[str, Histogram] = {}      # guarded-by: self._lock
        self._accumulators: Dict[str, Accumulator] = {}  # guarded-by: self._lock
        self._info: Dict[str, object] = {}               # guarded-by: self._lock
        self._seq = 0                                    # guarded-by: self._lock

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            return h

    def accumulator(self, name: str) -> Accumulator:
        with self._lock:
            a = self._accumulators.get(name)
            if a is None:
                a = self._accumulators[name] = Accumulator()
            return a

    def set_info(self, name: str, value) -> None:
        """Publish a STRUCTURAL fact (JSON-able, e.g. the bucket->device
        census `serve_device_assignments`) that a flat numeric metric
        cannot carry. Rides the snapshot under "info" and renders as a
        `# name json` comment line in the text format — structure for
        humans/tests, no prometheus parser ever sees a non-numeric
        sample."""
        with self._lock:
            self._info[name] = value

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
            accumulators = dict(self._accumulators)
            info = dict(self._info)
            # monotonic per-registry sequence + capture wall-clock:
            # a scrape whose seq did not advance came from a wedged or
            # cached source
            self._seq += 1
            seq = self._seq
        return {
            "seq": seq,
            "captured_at": time.time(),
            "info": info,
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(histograms.items())},
            "accumulators": {k: a.value
                             for k, a in sorted(accumulators.items())},
        }

    def render_text(self) -> str:
        return render_snapshot_text(self.snapshot())


def render_snapshot_text(snap: dict) -> str:
    """Snapshot dict -> the prometheus-ish text format."""
    lines = []
    for k, v in snap["info"].items():
        lines.append(f"# {k} {json.dumps(v, sort_keys=True)}")
    for k, v in snap["counters"].items():
        lines.append(f"{k}_total {v}")
    for k, v in snap["gauges"].items():
        lines.append(f"{k} {v:g}")
    for k, v in snap["accumulators"].items():
        lines.append(f"{k} {v:g}")
    for k, s in snap["histograms"].items():
        lines.append(f"{k}_count {s['count']}")
        for stat in ("mean", "p50", "p99", "min", "max"):
            if stat in s:
                lines.append(f"{k}_{stat} {s[stat]:g}")
    return "\n".join(lines) + "\n"


# -- fleet merge helpers -------------------------------------------------------
#
# The router's AggregatedMetrics (serve/router.py) folds replica scrapes
# through these: counters, gauges and accumulators SUM; histograms fold as
# total count, count-weighted mean, worst-source p50/p99, and min/min-max/
# max tails.

def hist_partials(histograms: Dict[str, dict]) -> Dict[str, list]:
    """Seed the running merge state from one snapshot's histogram
    summaries: name -> [count, weighted_sum, p50s, p99s, mins, maxs]
    (min/max guarded with `in` for sources predating them)."""
    return {k: [s["count"], s["mean"] * s["count"], [s["p50"]],
                [s["p99"]],
                [s["min"]] if "min" in s else [],
                [s["max"]] if "max" in s else []]
            for k, s in histograms.items()}


def merge_numeric_sections(counters: Dict[str, float],
                           gauges: Dict[str, float],
                           accumulators: Dict[str, float],
                           hist: Dict[str, list], snap: dict) -> None:
    """Fold one source snapshot's numeric sections into the running
    merge state in place (histograms into `hist_partials` shape)."""
    for k, v in snap.get("counters", {}).items():
        counters[k] = counters.get(k, 0) + v
    for k, v in snap.get("gauges", {}).items():
        gauges[k] = gauges.get(k, 0.0) + v
    for k, v in snap.get("accumulators", {}).items():
        accumulators[k] = accumulators.get(k, 0.0) + v
    for k, s in snap.get("histograms", {}).items():
        part = hist.setdefault(k, [0, 0.0, [], [], [], []])
        part[0] += s["count"]
        part[1] += s["mean"] * s["count"]
        part[2].append(s["p50"])
        part[3].append(s["p99"])
        if "min" in s:
            part[4].append(s["min"])
        if "max" in s:
            part[5].append(s["max"])


def fold_hist_partials(hist: Dict[str, list]) -> Dict[str, dict]:
    """Running merge state -> final histogram summaries: quantiles do
    not compose exactly from summaries, so the aggregate reports the
    WORST source p50/p99 (the honest SLO view) while the alarm tails
    (min/max) survive the merge exactly."""
    return {
        k: {"count": c,
            "mean": (wsum / c) if c else 0.0,
            "p50": max(p50s) if p50s else 0.0,
            "p99": max(p99s) if p99s else 0.0,
            **({"min": min(mins)} if mins else {}),
            **({"max": max(maxs)} if maxs else {})}
        for k, (c, wsum, p50s, p99s, mins, maxs) in sorted(hist.items())}


class MetricsServer:
    """`/healthz` + `/metrics` (+ `/trace`) on a daemon thread; port 0 =
    ephemeral (tests read `.port` after start).

    `trace` is an optional provider called with the request's query
    params (flattened `{key: value}`) returning a JSON-able body — the
    service passes its tracer's view. Without a provider /trace answers
    404."""

    def __init__(self, registry: MetricsRegistry,
                 health: Callable[[], dict],
                 port: int = 0, host: str = "127.0.0.1",
                 trace: Optional[Callable[[Mapping[str, str]],
                                          object]] = None):
        registry_ref, health_ref, trace_ref = registry, health, trace

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: ARG002
                pass  # request logging would interleave with service logs

            def _send(self, code: int, body: str, ctype: str) -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
                url = urlparse(self.path)
                if url.path == "/healthz":
                    state = health_ref()
                    # degraded (pool below configured but alive) still
                    # serves — a load balancer should keep routing here;
                    # unhealthy (zero workers) and draining must 503
                    code = (200 if state.get("status") in ("ok", "degraded")
                            else 503)
                    self._send(code, json.dumps(state), "application/json")
                elif url.path == "/metrics":
                    if "format=json" in (url.query or ""):
                        self._send(200, json.dumps(registry_ref.snapshot()),
                                   "application/json")
                    else:
                        self._send(200, registry_ref.render_text(),
                                   "text/plain; version=0.0.4")
                elif url.path == "/trace" and trace_ref is not None:
                    params = {k: v[-1] for k, v in
                              parse_qs(url.query or "").items()}
                    self._send(200, json.dumps(trace_ref(params),
                                               default=str),
                               "application/json")
                else:
                    self._send(404, "not found\n", "text/plain")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="serve-metrics", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
