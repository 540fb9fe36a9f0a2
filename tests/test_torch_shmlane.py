"""The port's shared-memory lane transport (`dsin_tpu_torch/serve/shmlane.py`)
against the JAX package's `serve/shmlane.py`, on the CPU.

The cases of tests/test_shmlane.py that do not need the router: the
every-bit sweep of a frame held in a mapped segment, the descriptor and
header liars, oversize and exhaustion falling back counted, the claim /
`write_into` reply pattern, unlink, and concurrent claims. Then the two
packages side by side: `derive_lane_classes` equal on the same bounds, and
a frame written by either package's ring read by the other's
`LaneRing.attach(manifest).take`, byte-equal. Every check is exact.
"""

import glob
import struct
import threading

import pytest

from dsin_tpu.serve import shmlane as jax_shmlane
from dsin_tpu_torch.serve import metrics as metrics_lib
from dsin_tpu_torch.serve import shmlane
from dsin_tpu_torch.utils import faults
from dsin_tpu_torch.utils.integrity import IntegrityError
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.uninstall()
    yield
    faults.uninstall()


def _ring(metrics=None, lane_bytes=4096 - shmlane.FRAME_OVERHEAD,
          n_lanes=2, name="t", lib=shmlane):
    classes = [lib.LaneClass("a", lane_bytes, n_lanes)]
    return lib.LaneRing.create(name, classes, metrics=metrics)


def _flip_bit(ring, byte_off, bit):
    ring._shm.buf[byte_off + bit // 8] ^= 1 << (bit % 8)


# -- framing: the exhaustive sweep -------------------------------------------

def test_every_single_bit_flip_in_the_frame_raises_typed():
    """Flip every bit of [length][crc][payload] in place: every take()
    raises ValueError (IntegrityError is one); the pristine frame reads."""
    ring = _ring()
    try:
        payload = bytes(range(48))
        ref = ring.put(payload)
        assert ref is not None
        for bit in range((shmlane.FRAME_OVERHEAD + len(payload)) * 8):
            _flip_bit(ring, ref.offset, bit)
            with pytest.raises(ValueError):
                ring.take(ref)
            _flip_bit(ring, ref.offset, bit)   # restore
        assert ring.take(ref) == payload
    finally:
        ring.unlink()


def test_payload_flip_is_specifically_a_crc_mismatch():
    ring = _ring()
    try:
        ref = ring.put(bytes(range(48)))
        _flip_bit(ring, ref.offset, shmlane.FRAME_OVERHEAD * 8 + 5)
        with pytest.raises(IntegrityError, match="CRC mismatch"):
            ring.take(ref)
    finally:
        ring.unlink()


def test_fault_site_corrupts_lane_reads():
    """The serve.shm.lane site models bytes rotting in the segment between
    write and read: the CRC catches it."""
    assert "serve.shm.lane" in faults.SITES
    ring = _ring()
    try:
        ref = ring.put(b"x" * 64)
        plan = faults.FaultPlan(
            [faults.FaultSpec(site="serve.shm.lane", action="corrupt")],
            seed=3)
        with faults.installed(plan):
            with pytest.raises(IntegrityError, match="CRC mismatch"):
                ring.take(ref)
        assert plan.activations["serve.shm.lane"] == 1
    finally:
        ring.unlink()


# -- geometry liars: refused before the CRC ----------------------------------

@pytest.mark.parametrize("liar,match", [
    (lambda r: shmlane.LaneRef(r.ring, r.cls, r.lane, r.offset, 64),
     "geometry liar"),
    (lambda r: shmlane.LaneRef(r.ring, r.cls, r.lane, r.offset + 8,
                               r.length), "lying descriptor")],
    ids=["length", "offset"])
def test_descriptor_liars_are_refused(liar, match):
    ring = _ring()
    try:
        ref = ring.put(b"y" * 100)
        with pytest.raises(IntegrityError, match=match):
            ring.take(liar(ref))
    finally:
        ring.unlink()


def test_header_length_overflowing_the_lane_is_refused():
    """A forged in-lane header claiming more than the lane holds must not
    drive a read past the lane end, even when the descriptor agrees."""
    ring = _ring()
    try:
        ref = ring.put(b"w" * 16)
        huge = ring._classes[0].lane_bytes
        struct.pack_into("<I", ring._shm.buf, ref.offset, huge)
        liar = shmlane.LaneRef(ref.ring, ref.cls, ref.lane, ref.offset,
                               huge)
        with pytest.raises(IntegrityError, match="overflows"):
            ring.take(liar)
    finally:
        ring.unlink()


@pytest.mark.parametrize("bogus,match", [
    (lambda r: shmlane.LaneRef(r.ring, r.cls, 99, r.offset, r.length),
     "only"),
    (lambda r: shmlane.LaneRef(r.ring, "nope", 0, r.offset, r.length),
     "unknown lane"),
    (lambda r: shmlane.LaneRef("other-ring", r.cls, r.lane, r.offset,
                               r.length), "ring")],
    ids=["lane", "class", "ring"])
def test_bogus_descriptor_targets_raise_shmlane_error(bogus, match):
    ring = _ring()
    try:
        ref = ring.put(b"q" * 16)
        with pytest.raises(shmlane.ShmLaneError, match=match):
            ring.take(bogus(ref))
    finally:
        ring.unlink()


# -- fallback: oversize / exhausted -> None, typed + counted ------------------

def test_oversize_and_exhaustion_fall_back_counted():
    reg = metrics_lib.MetricsRegistry()
    ring = _ring(metrics=reg, n_lanes=2)
    seen = []
    ring.on_fallback = lambda reason, n: seen.append(reason)
    try:
        cap = ring._classes[0].lane_bytes - shmlane.FRAME_OVERHEAD
        assert ring.put(b"a" * cap) is not None
        assert ring.put(b"b" * cap) is not None
        assert ring.put(b"c" * cap) is None            # exhausted
        assert ring.put(b"d" * (cap + 1)) is None      # oversize
        snap = reg.snapshot()["counters"]
        assert snap["serve_shm_fallbacks"] == 2
        assert snap["serve_shm_fallback_exhausted"] == 1
        assert snap["serve_shm_fallback_oversize"] == 1
        assert snap["serve_shm_sends"] == 2
        assert seen == ["exhausted", "oversize"]
    finally:
        ring.unlink()


def test_small_pickles_stay_inline_without_counting_fallback():
    reg = metrics_lib.MetricsRegistry()
    ring = _ring(metrics=reg)
    try:
        assert ring.put_obj({"tiny": 1}) is None
        assert reg.snapshot()["counters"].get("serve_shm_fallbacks", 0) == 0
        big = {"k": b"z" * shmlane.SMALL_INLINE_MAX}
        ring2 = _ring(lane_bytes=64 * 1024, name="t2")
        try:
            assert ring2.take_obj(ring2.put_obj(big)) == big
        finally:
            ring2.unlink()
    finally:
        ring.unlink()


def test_freed_lane_is_reusable_and_free_unblocks_exhaustion():
    ring = _ring(n_lanes=1)
    try:
        ref = ring.put(b"one")
        assert ring.put(b"two") is None          # exhausted
        assert ring.take(ref) == b"one"          # receiver frees
        ref2 = ring.put(b"two")
        assert ref2 is not None and ring.take(ref2) == b"two"
        ref3 = ring.claim(8)
        ring.free(ref3)                          # free without reading
        assert ring.claim(8) is not None
    finally:
        ring.unlink()


# -- reply-lane pattern + attach ---------------------------------------------

def test_claim_then_write_into_reply_pattern_roundtrips():
    """The entropy pool's shape: the parent claims the reply lane, the
    worker writes a shorter payload into it, the returned descriptor carries
    the written length, and the parent copies out with free=False."""
    ring = _ring()
    try:
        reply = ring.claim(2048)
        worker_view = shmlane.LaneRing.attach(ring.manifest())
        try:
            written = worker_view.write_into(reply, b"result" * 10)
            assert written.length == 60 and written.lane == reply.lane
        finally:
            worker_view.close()
        assert ring.take(written, free=False) == b"result" * 10
        assert ring.take(written, free=False) == b"result" * 10  # not freed
        ring.free(written)
        with pytest.raises(shmlane.ShmLaneError, match="does not fit"):
            ring.write_into(ring.claim(8), b"x" * 8192)
    finally:
        ring.unlink()


def test_unlink_census_and_idempotence():
    ring = _ring(name="census")
    seg = f"/dev/shm/{ring.name}"
    assert glob.glob(seg), "segment not visible in /dev/shm"
    # the JAX package's leak census globs "dsin-*": the port's rings are
    # named apart, so the two packages' tests never see each other's
    assert seg not in glob.glob("/dev/shm/dsin-*")
    ring.unlink()
    ring.unlink()                                 # safe to call twice
    assert not glob.glob(seg)
    assert ring.put(b"late") is None              # closed -> inline
    ring.free(shmlane.LaneRef(ring.name, "a", 0, 0, 0))   # no-op


def test_derive_lane_classes_rounds_to_alignment():
    classes = shmlane.derive_lane_classes([("b16x24", 100)], 3)
    assert classes[0].lane_bytes == 4096 and classes[0].n_lanes == 3
    big = shmlane.derive_lane_classes([("b", 4096)], 1)[0]
    assert big.lane_bytes == 8192                 # 4096 + overhead rounds up
    with pytest.raises(ValueError, match="positive geometry"):
        shmlane.LaneClass("bad", 0, 4)


def test_concurrent_claims_never_hand_out_the_same_lane():
    """8 lanes, 4 threads claiming and freeing: a lane is never held by two
    threads at once."""
    ring = _ring(n_lanes=8)
    try:
        held, errs = set(), []
        held_lock = threading.Lock()

        def worker():
            try:
                for _ in range(200):
                    ref = ring.claim(64)
                    if ref is None:
                        continue
                    with held_lock:
                        assert ref.lane not in held, ref.lane
                        held.add(ref.lane)
                    with held_lock:
                        held.discard(ref.lane)
                    ring.free(ref)
            except Exception as e:  # noqa: BLE001 — fail the test below
                errs.append(e)

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errs
    finally:
        ring.unlink()


# -- the two packages side by side --------------------------------------------

@pytest.mark.parametrize("bounds,n_lanes", [
    ([("b16x24", 100)], 3), ([("b", 4096)], 1),
    ([("ent", 4 * 32 * 40 * 153 * 4 + 65536), ("small", 1)], 18)])
def test_derive_lane_classes_equal_the_jax_package(bounds, n_lanes):
    got = shmlane.derive_lane_classes(bounds, n_lanes)
    want = jax_shmlane.derive_lane_classes(bounds, n_lanes)
    assert [(c.name, c.lane_bytes, c.n_lanes) for c in got] == \
        [(c.name, c.lane_bytes, c.n_lanes) for c in want]
    assert shmlane.FRAME_OVERHEAD == jax_shmlane.FRAME_OVERHEAD
    assert shmlane.SMALL_INLINE_MAX == jax_shmlane.SMALL_INLINE_MAX


@pytest.mark.parametrize("writer,reader", [
    (shmlane, jax_shmlane), (jax_shmlane, shmlane)],
    ids=["port_to_jax", "jax_to_port"])
def test_frames_cross_the_packages_byte_equal(writer, reader):
    """A frame one package's ring writes is read by the other package's
    `LaneRing.attach(manifest).take`, byte-equal, and the segment's bytes
    (header and payload) are the same whichever package wrote them."""
    payload = bytes(range(256)) * 40
    rings = [_ring(lane_bytes=16 * 1024, name=f"x{i}", lib=lib)
             for i, lib in enumerate((writer, reader))]
    try:
        frames = []
        for ring in rings:
            ref = ring.put(payload)
            frames.append(bytes(ring._shm.buf[
                ref.offset:ref.offset + shmlane.FRAME_OVERHEAD + ref.length]))
        assert frames[0] == frames[1]
        ref = rings[0].put(payload)
        view = reader.LaneRing.attach(rings[0].manifest())
        try:
            ref_r = reader.LaneRef(ref.ring, ref.cls, ref.lane, ref.offset,
                                   ref.length)
            assert view.take(ref_r, free=False) == payload
        finally:
            view.close()
    finally:
        for ring in rings:
            ring.unlink()
