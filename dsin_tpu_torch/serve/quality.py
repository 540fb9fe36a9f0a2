"""Model-health telemetry: coding gap, SI-match quality, golden canary (a
copy of the JAX package's `serve/quality.py`, host code only).

* **Coding gap**: per-request realized payload bits vs the model's own
  `BottleneckCodec.ideal_bits` bound under the quantized tables (one
  definition: `codec.coding_gap`, coding/codec.py). The bound costs a
  second engine pass per sampled request, so it is HEAD-SAMPLED with a
  deterministic counter rotation (`gap_sample_rate`; no RNG, so a replayed
  stream samples the same requests) and runs on the entropy-pool thread
  after the request's future resolved, never under a lock and never on
  the caller's latency. Exported as per-bucket
  `serve_coding_gap_pct_<bh>x<bw>` histograms: a RISING gap means the
  context model no longer matches the data.

* **SI-match quality**: the prepped patch search can return its winning
  masked Pearson score per patch (ops/sifinder.py `with_scores`, on the
  routes that have them; the kernel K2 does not, see
  `ops/sifinder.service_si_scores`), and `QualityMonitor` summarizes them
  PER SESSION (mean / min top score, fraction below the floor). A session
  whose side image stops correlating crosses `si_alarm_frac` below
  `si_score_floor` and arms a quality alarm: the `serve_si_match_alarms`
  gauge, a transition counter and a `quality_alarm` flight event.

* **Golden canary**: pinned deterministic inputs (`canary_inputs`, one per
  existing bucket shape, so the canary runs the warmed shapes and builds
  nothing) driven through the real serve path on a period, output digests
  compared against goldens recorded in the checkpoint manifest
  (`manifest_extra["canary"]`, train/checkpoint.py), or self-anchored at
  the first probe of a model whose manifest carries none. A mismatch is
  definitive (pinned inputs, deterministic kernels): it exports
  `serve_canary_*` metrics, dumps the flight recorder, refuses a swap
  commit typed (`CanaryFailed`, serve/service.py `prepare_swap` probes the
  STAGED bundle) and, after a commit, arms the `RollbackWatchdog`
  (serve/swap.py).

`canary_inputs` gives the JAX package's arrays bit for bit (goldens are
keyed by them), and `validate_goldens` / `compare_goldens` /
`wave_canary_verdict` are the JAX package's rules, so goldens written by
either package are checked the same way by the other.

Mutable state lives under a `threading.Lock` per object (the JAX package's
ranked `serve.quality` lock); the session store's evict hook calls
`session_gone` from under the store's lock, and nothing here calls back
into the store. Canary probes hold NO quality lock while they run the
serve path: only the verdict bookkeeping is locked.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dsin_tpu_torch.serve.batcher import ServeError


class CanaryFailed(ServeError):
    """The golden canary's output digests disagree with the model's
    recorded goldens — the model computes something other than what its
    publisher verified (degraded params, numerics drift, a loading
    bug). A swap prepare raising this refuses the commit: the service
    keeps serving the old, known-good model."""


def digest_bytes(data: bytes) -> str:
    """The canary's ONE digest: 16 hex chars of sha256, matching the
    repo's params_digest width (coding/loader.py)."""
    return hashlib.sha256(data).hexdigest()[:16]


def bucket_key(bucket: Tuple[int, int]) -> str:
    return f"{bucket[0]}x{bucket[1]}"


def canary_inputs(buckets: Sequence[Tuple[int, int]],
                  seed: int) -> Dict[Tuple[int, int], Tuple[np.ndarray,
                                                            np.ndarray]]:
    """Deterministic pinned probe inputs, one (image, side image) pair
    per EXISTING bucket shape — the canary must ride the warmed
    shapes, never add one. The image is structured (gradient +
    seeded noise: exercises both the smooth and the textured regimes of
    probclass) and the side image is the same content shifted two
    pixels, so the SI search has a genuinely correlated match to find.
    Keyed by (seed, bucket) so every replica and every publisher derives
    bit-identical inputs with no coordination."""
    out = {}
    for bh, bw in buckets:
        rng = np.random.default_rng((int(seed), int(bh), int(bw)))
        yy = np.linspace(0.0, 255.0, bh, dtype=np.float32)[:, None, None]
        xx = np.linspace(0.0, 255.0, bw, dtype=np.float32)[None, :, None]
        grad = 0.5 * yy + 0.5 * xx
        noise = rng.uniform(-64.0, 64.0, (bh, bw, 3)).astype(np.float32)
        img = np.clip(grad + noise, 0, 255).astype(np.uint8)
        side = np.roll(img, shift=(2, 2), axis=(0, 1))
        out[(bh, bw)] = (img, side)
    return out


# contract: pure
def goldens_struct(seed: int, buckets: Sequence[Tuple[int, int]],
                   digests: Dict[str, Dict[str, Optional[str]]]
                   ) -> Dict[str, Any]:
    """The `manifest_extra["canary"]` schema a checkpoint publisher
    records (train/checkpoint.py validates the shape at save): the
    input seed, the bucket ladder the digests cover, and per-bucket
    {"encode", "decode", "decode_si"} output digests ("decode_si" is
    None when published without the SI path)."""
    return {"seed": int(seed),
            "buckets": [list(b) for b in buckets],
            "digests": {k: dict(v) for k, v in sorted(digests.items())}}


# contract: pure
def validate_goldens(goldens: Any) -> Optional[str]:
    """Structural check of a manifest `canary` entry; returns a human
    reason when malformed, None when well-formed. Shared by the
    manifest writer (refuse publishing junk) and the swap-time reader
    (a malformed entry is a refusal, not a skip)."""
    if not isinstance(goldens, dict):
        return f"canary goldens must be a dict, got {type(goldens).__name__}"
    if not isinstance(goldens.get("seed"), int):
        return "canary goldens carry no integer 'seed'"
    bks = goldens.get("buckets")
    if (not isinstance(bks, list) or not bks
            or any(not isinstance(b, (list, tuple)) or len(b) != 2
                   for b in bks)):
        return "canary goldens carry no bucket ladder"
    digs = goldens.get("digests")
    if not isinstance(digs, dict) or not digs:
        return "canary goldens carry no per-bucket digests"
    for key, entry in digs.items():
        if not isinstance(entry, dict) or "encode" not in entry \
                or "decode" not in entry:
            return (f"canary goldens bucket {key!r} must record 'encode' "
                    f"and 'decode' digests")
    return None


# contract: pure
def compare_goldens(expected: Dict[str, Any],
                    observed: Dict[str, Dict[str, Optional[str]]], *,
                    seed: int,
                    buckets: Sequence[Tuple[int, int]]) -> List[str]:
    """Golden-vs-observed verdict; returns mismatch descriptions (empty
    = canary passes). The comparison REFUSES (reports) configuration
    skew it cannot verify across — a different canary seed or a bucket
    the goldens never covered — instead of silently skipping: goldens
    that cannot be checked protect nothing. `decode_si` compares only
    when both sides recorded it (a checkpoint published without the SI
    path still canaries its encode/decode on an SI-serving fleet)."""
    problems: List[str] = []
    bad = validate_goldens(expected)
    if bad is not None:
        return [bad]
    if int(expected["seed"]) != int(seed):
        return [f"goldens were recorded for canary seed "
                f"{expected['seed']}, this service probes seed {seed} — "
                f"different inputs cannot be compared"]
    want = expected["digests"]
    for bucket in buckets:
        key = bucket_key(bucket)
        if key not in want:
            problems.append(f"goldens record no digests for served "
                            f"bucket {key}")
            continue
        got = observed.get(key) or {}
        for op in ("encode", "decode", "decode_si"):
            exp_d = want[key].get(op)
            got_d = got.get(op)
            if exp_d is None or got_d is None:
                continue   # op not covered on one side: not comparable
            if exp_d != got_d:
                problems.append(f"{key} {op}: golden {exp_d}, "
                                f"observed {got_d}")
    return problems


# contract: pure
def wave_canary_verdict(quality: Optional[Dict[str, Any]],
                        expect_digest: str) -> Optional[bool]:
    """One member's aggregated quality roll-up -> wave-gate verdict for
    a just-committed digest (the rollout wave's canary gate of the JAX
    package's federation tier; pure, so the federation can poll it and tests
    can table-drive it).

    Returns False the moment ANY replica reports a failed/errored
    canary verdict AGAINST `expect_digest` — the probe ran through the
    new model's real serve path and mismatched, the one signal that
    must stop a promotion. Returns True only when every live canary
    verdict in the roll-up covers `expect_digest` and reports "ok"
    (verdicts still naming the OLD digest mean the prober simply has
    not rerun since the commit). Anything else — no verdicts yet,
    partial coverage, "busy"/"raced"/"skipped" statuses — is None:
    evidence still incomplete, keep polling until the gate's deadline
    (an expired deadline is the caller's typed failure, never a
    silent pass)."""
    canary = (quality or {}).get("canary") or {}
    if not canary:
        return None
    covering = {i: c for i, c in canary.items()
                if isinstance(c, dict)
                and c.get("digest") == expect_digest}
    if any(c.get("status") in ("failed", "error")
           for c in covering.values()):
        return False
    if (len(covering) == len(canary)
            and all(c.get("status") == "ok"
                    for c in covering.values())):
        return True
    return None


#: per-session score history bound: once a session has accumulated 2x
#: this many scores, its counters HALVE (an exponential decay in O(1)
#: state) — the running fraction then tracks roughly the last
#: _SI_WINDOW scores, so a long-healthy session whose side image stops
#: correlating alarms within ~one window instead of needing its whole
#: lifetime of good history outvoted. `min` stays all-time (the worst
#: score ever is forensic, not a rate).
_SI_WINDOW = 512


class _SiStats:
    """Per-session score accumulator (plain fields; the monitor's lock
    guards every access). `n`/`total`/`below` are decayed counts (see
    _SI_WINDOW); `seen` counts every score ever observed."""

    __slots__ = ("n", "seen", "total", "min", "below", "alarmed")

    def __init__(self):
        self.n = 0
        self.seen = 0
        self.total = 0.0
        self.min = float("inf")
        self.below = 0
        self.alarmed = False

    def fold(self, count: int, total: float, vmin: float,
             below: int) -> None:
        self.n += count
        self.seen += count
        self.total += total
        self.min = min(self.min, vmin)
        self.below += below
        if self.n >= 2 * _SI_WINDOW:
            self.n //= 2
            self.below = (self.below + 1) // 2
            self.total /= 2.0

    def summary(self, floor: float) -> Dict[str, float]:
        return {"n": self.seen,
                "mean": round(self.total / self.n, 4) if self.n else 0.0,
                "min": round(self.min, 4) if self.n else 0.0,
                "frac_below_floor": round(self.below / self.n, 4)
                if self.n else 0.0,
                "floor": floor,
                "alarmed": self.alarmed}


class QualityMonitor:
    """The dataplane-facing half of model-health telemetry: bpp export,
    sampled coding gap, and the per-session SI-match tracker. One
    instance per service; every `note_*` call runs on a dataplane
    thread (entropy pool task / worker finish) and touches only the
    `serve.quality` lock plus the flight/metric leaves above it."""

    def __init__(self, metrics, flight=None, enabled: bool = True,
                 gap_sample_rate: float = 1.0 / 16.0,
                 si_score_floor: float = 0.25,
                 si_alarm_frac: float = 0.5,
                 si_alarm_min_samples: int = 8):
        if not 0.0 <= gap_sample_rate <= 1.0:
            raise ValueError(f"gap_sample_rate must be in [0, 1], "
                             f"got {gap_sample_rate}")
        if not 0.0 < si_alarm_frac <= 1.0:
            raise ValueError(f"si_alarm_frac must be in (0, 1], "
                             f"got {si_alarm_frac}")
        if si_alarm_min_samples < 1:
            raise ValueError(f"si_alarm_min_samples must be >= 1, "
                             f"got {si_alarm_min_samples}")
        self.metrics = metrics
        self.flight = flight
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._gap_n = 0                   # guarded-by: self._lock
        self._gap_rate = float(gap_sample_rate)  # guarded-by: self._lock
        self.si_score_floor = float(si_score_floor)
        self.si_alarm_frac = float(si_alarm_frac)
        self.si_alarm_min_samples = int(si_alarm_min_samples)
        self._si: Dict[str, _SiStats] = {}       # guarded-by: self._lock
        self._alarmed = 0                        # guarded-by: self._lock

    # -- knobs ---------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> bool:
        """Flip observation (the bench's paired-overhead toggle). The
        device path never changes (the score decision is made at start);
        only the host-side bookkeeping stops."""
        prev = self._enabled
        self._enabled = bool(on)
        return prev

    @property
    def gap_sample_rate(self) -> float:
        with self._lock:
            return self._gap_rate

    def set_gap_sample_rate(self, rate: float) -> float:
        """Retune the gap head sampler (benches force 1.0 to populate
        histograms in a short pass); returns the previous rate."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"gap_sample_rate must be in [0, 1], "
                             f"got {rate}")
        with self._lock:
            prev, self._gap_rate = self._gap_rate, float(rate)
        return prev

    # -- coding gap + bpp (encode path) --------------------------------------

    def sample_gap(self) -> bool:
        """The deterministic head rotation at `gap_sample_rate`:
        the Nth encode is sampled iff floor((N+1)*r) > floor(N*r). The
        unsampled path is one lock-guarded counter bump."""
        if not self._enabled:
            return False
        with self._lock:
            rate = self._gap_rate
            if rate <= 0.0:
                return False
            n = self._gap_n
            self._gap_n = n + 1
            return int((n + 1) * rate) > int(n * rate)

    def note_encode(self, bucket: Tuple[int, int], shape: Tuple[int, int],
                    payload_bytes: int, wire_bytes: int) -> None:
        """Always-on bpp export: payload bpp (entropy-coded bits over
        ORIGINAL pixels) and wire bpp (the framed stream — DSRV header +
        CRC overhead visible) per bucket."""
        if not self._enabled:
            return
        h, w = shape
        px = max(1, h * w)
        key = bucket_key(bucket)
        self.metrics.histogram(f"serve_bpp_payload_{key}").observe(
            payload_bytes * 8.0 / px)
        self.metrics.histogram(f"serve_bpp_wire_{key}").observe(
            wire_bytes * 8.0 / px)

    def note_gap(self, bucket: Tuple[int, int], gap: Dict[str, float]
                 ) -> None:
        """Record one sampled gap measurement (`codec.coding_gap`'s
        dict) into the per-bucket histograms."""
        if not self._enabled:
            return
        key = bucket_key(bucket)
        self.metrics.histogram(f"serve_coding_gap_pct_{key}").observe(
            gap["gap_pct"])
        self.metrics.histogram("serve_coding_gap_bits").observe(
            gap["gap_bits"])
        self.metrics.counter("serve_coding_gap_samples").inc()

    def observe_gap(self, codec, volume: np.ndarray, stream: bytes,
                    bucket: Tuple[int, int]) -> Optional[Dict[str, float]]:
        """The sampled extra pass, called AFTER the request's future
        resolved (entropy-pool placement; pure numpy — the incremental
        engine builds nothing, so this never reaches a native build). A codec
        refusal (pathological stream) is swallowed into an error
        counter: telemetry must never fail a request that already
        succeeded."""
        if not self._enabled:
            return None
        try:
            gap = codec.coding_gap(volume, stream)
        except Exception:   # noqa: BLE001 — telemetry never hurts traffic
            self.metrics.counter("serve_coding_gap_errors").inc()
            return None
        self.note_gap(bucket, gap)
        return gap

    # -- SI-match quality (decode_si path) -----------------------------------

    def session_open(self, sid: str) -> None:
        """Register a session with the tracker (the service calls this
        right after the store `put`). Tracker entries exist ONLY
        between here and the store's evict hook: `note_si_scores` for
        an unknown sid drops the scores instead of lazily re-creating
        the entry — a batch finishing after its session was evicted
        must not resurrect a phantom session whose alarm nobody could
        ever clear."""
        with self._lock:
            self._si.setdefault(sid, _SiStats())

    def note_si_scores(self, sid: str, scores: np.ndarray) -> None:
        """Fold one request's winning per-patch scores into its
        session's summary and evaluate the alarm transition. Alarm
        semantics: once `si_alarm_min_samples` scores accumulated, a
        session with >= `si_alarm_frac` of them below `si_score_floor`
        ARMS (flight `quality_alarm` armed=True, transition counter,
        live-alarm gauge); recovery below half that fraction CLEARS —
        the hysteresis keeps a borderline session from flapping events.
        The counts decay past _SI_WINDOW scores, so a session's alarm
        latency is bounded by the window, not its lifetime. The
        no-transition fast path is O(1) under the lock (the live-alarm
        census is an incremental counter, never a scan)."""
        if not self._enabled:
            return
        scores = np.asarray(scores, dtype=np.float64).reshape(-1)
        if scores.size == 0:
            return
        floor = self.si_score_floor
        self.metrics.histogram("serve_si_match_score").observe(
            float(scores.mean()))
        self.metrics.histogram("serve_si_match_min_score").observe(
            float(scores.min()))
        transition = None
        with self._lock:
            st = self._si.get(sid)
            if st is None:
                # the session was evicted while this batch was in
                # flight (see session_open) — its summary is gone and
                # must stay gone
                return
            st.fold(scores.size, float(scores.sum()),
                    float(scores.min()), int((scores < floor).sum()))
            if st.seen >= self.si_alarm_min_samples:
                frac = st.below / st.n
                if not st.alarmed and frac >= self.si_alarm_frac:
                    st.alarmed = True
                    self._alarmed += 1
                    transition = ("armed", st.summary(floor),
                                  self._alarmed)
                elif st.alarmed and frac < self.si_alarm_frac / 2.0:
                    st.alarmed = False
                    self._alarmed -= 1
                    transition = ("cleared", st.summary(floor),
                                  self._alarmed)
        if transition is not None:
            state, summary, alarmed_now = transition
            self.metrics.counter("serve_si_match_alarm_transitions").inc()
            self.metrics.gauge("serve_si_match_alarms").set(alarmed_now)
            if self.flight is not None:
                self.flight.record("quality_alarm", signal="si_match",
                                   sid=sid, state=state, **summary)

    def session_gone(self, sid: str, reason: str) -> None:
        """SessionStore evict hook (runs under the store's lock; this
        lock is only ever taken after it, never before): drop the
        session's stats and clear its live alarm."""
        with self._lock:
            st = self._si.pop(sid, None)
            if st is not None and st.alarmed:
                self._alarmed -= 1
            alarmed_now = self._alarmed
        if st is not None and st.alarmed:
            self.metrics.gauge("serve_si_match_alarms").set(alarmed_now)
            if self.flight is not None:
                self.flight.record("quality_alarm", signal="si_match",
                                   sid=sid, state="session_gone",
                                   reason=reason)

    def si_session_summaries(self) -> Dict[str, Dict[str, float]]:
        """{sid: {n, mean, min, frac_below_floor, floor, alarmed}} for
        /healthz, benches, and the chaos battery."""
        with self._lock:
            return {sid: st.summary(self.si_score_floor)
                    for sid, st in self._si.items()}


class CanaryState:
    """Baseline + verdict bookkeeping for the canary prober (the probes
    themselves run lock-free through the serve path; serve/service.py
    owns them). Baselines are keyed by SERVING DIGEST: a swap or
    rollback starts a fresh comparison — against the incoming model's
    manifest goldens when it carries comparable ones, else
    self-anchored at that model's first successful probe (drift
    detection without a publisher)."""

    def __init__(self, seed: int, metrics, flight=None):
        self.seed = int(seed)
        self.metrics = metrics
        self.flight = flight
        self._lock = threading.Lock()
        # digest -> {"source": "manifest"|"self", "goldens": struct}
        self._baseline: Dict[str, Dict[str, Any]] = {}  # guarded-by: self._lock
        self._last: Optional[Dict[str, Any]] = None     # guarded-by: self._lock
        self._busy = False                              # guarded-by: self._lock

    def claim(self) -> bool:
        """One probe at a time (the background prober and an operator's
        manual `run_canary` must not interleave their serve-path
        requests): non-blocking — a loser returns False and skips."""
        with self._lock:
            if self._busy:
                return False
            self._busy = True
        return True

    def release(self) -> None:
        with self._lock:
            self._busy = False

    def baseline_for(self, model_digest: str, manifest: Optional[dict],
                     buckets: Sequence[Tuple[int, int]],
                     observed: Dict[str, Dict[str, Optional[str]]]
                     ) -> Tuple[str, List[str]]:
        """Resolve (anchoring if needed) the baseline for one probe's
        model and return ("manifest"|"self"|"anchored", mismatches)."""
        goldens = (manifest or {}).get("canary")
        # "comparable" means FULLY: well-formed, same input seed, and
        # covering every served bucket. The swap-time gate refuses a
        # partially-comparable manifest typed (adopting a NEW model
        # demands that strictness); the running prober instead
        # self-anchors — a healthy model serving a widened ladder must
        # drift-monitor, not page a permanent false canary failure.
        comparable = (goldens is not None
                      and validate_goldens(goldens) is None
                      and int(goldens.get("seed", -1)) == self.seed
                      and all(bucket_key(tuple(b)) in goldens["digests"]
                              for b in buckets))
        with self._lock:
            base = self._baseline.get(model_digest)
            if base is None:
                if comparable:
                    base = {"source": "manifest", "goldens": goldens}
                else:
                    # no comparable publisher truth: anchor on this
                    # first probe — later probes of the SAME digest
                    # must reproduce it bit for bit
                    base = {"source": "self",
                            "goldens": goldens_struct(
                                self.seed, buckets, observed)}
                    self._baseline[model_digest] = base
                    return "anchored", []
                self._baseline[model_digest] = base
            expected = base["goldens"]
        return base["source"], compare_goldens(
            expected, observed, seed=self.seed, buckets=buckets)

    def note_result(self, result: Dict[str, Any]) -> None:
        with self._lock:
            self._last = result
        self.metrics.set_info("serve_canary", result)

    @property
    def last(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._last
