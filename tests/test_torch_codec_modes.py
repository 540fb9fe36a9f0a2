"""Codec stream modes 0 (sequential) and 1 (wavefront) of the port against
the JAX package's jit engines, on the tiny configuration's context model
(the bridged ResShallow of tests/test_torch_codec_slice.py).

What is pinned:
* the logits of `_block_logits_batch` and `_block_logits` against JAX's
  within rtol 1e-5, atol 1e-6 (one ResShallow call of cuDNN's / oneDNN's
  `conv3d` against XLA's convolution: float32 sums in another order);
* exact round trips in both modes at odd shapes, a mode-0 stream equal to
  the one a hand-written walk of the sequential buffer gives, mode 1's
  power-of-two batches, identical on both sides of a stream;
* `ideal_bits` within 1e-3 relative of JAX's (a table may move by a few
  units of 65,536 where a logit moved by an ulp);
* the cross-package contract, measured at this configuration: the two
  packages' integer tables differ at a few positions (over the 12 volumes
  of CROSS_SHAPES: 10 of 2,610 positions in mode 0, in 7 volumes; 2 of
  2,610 in mode 1, 2 of its 1,461 fronts, in 2 volumes), so modes 0
  and 1 keep mode 3's same-process contract. Where every table of a volume
  agrees, the streams are byte-identical and decode in either package;
  where one differs, by at most 8 units, the stream belongs to the engine
  that wrote it.
"""

import struct

import jax
import numpy as np
import pytest

from dsin_tpu.coding import codec as jax_codec
from dsin_tpu.config import parse_config as jax_parse
from dsin_tpu.models import probclass as jax_pc
from dsin_tpu_torch import bridge
from dsin_tpu_torch.coding import codec as codec_lib
from dsin_tpu_torch.coding import rans
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models import probclass as pc_lib
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

L = 6
ODD_SHAPES = [(1, 1, 1), (2, 3, 17), (5, 12, 7)]
CROSS_SHAPES = [(8, 5, 6), (2, 3, 17), (5, 12, 7), (3, 4, 9)]
MODES = ["sequential", "wavefront"]
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
MAX_TABLE_DELTA = 8          # units of 1 << 16


@pytest.fixture(scope="module")
def codecs():
    """(port codec, JAX codec, port ResShallow) on one bridged context
    model with seeded weights and perturbed biases."""
    _, pc = tiny_configs()
    jcfg = jax_parse(str(pc))
    jpc = jax_pc.ResShallow(jcfg, L)
    params = jax.tree_util.tree_map(np.asarray, jpc.init(
        jax.random.PRNGKey(7), np.zeros((1, 5, 9, 9, 1), np.float32))
        ["params"])
    rng = np.random.default_rng(7)
    for layer in params.values():
        layer["bias"] = rng.normal(0, 0.1, layer["bias"].shape).astype(
            np.float32)
    res = pc_lib.ResShallow(pc, L)
    state = bridge.state_dict_from_jax({"probclass": params}, {})
    res.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()},
                        strict=True)
    centers = np.sort(rng.uniform(-2, 2, L)).astype(np.float32)
    port = codec_lib.BottleneckCodec(pc_lib.front_weight_matrices(res),
                                     centers, pc, device="cpu")
    return port, jax_codec.BottleneckCodec(jpc, params, centers, jcfg), res


def _symbols(seed, shape):
    return np.random.default_rng(seed).integers(0, L, shape)


def _known(symbols):
    return lambda front, cum_b, freqs_b: \
        symbols[front[:, 0], front[:, 1], front[:, 2]]


# -- the network ---------------------------------------------------------------

def test_the_rebuilt_network_is_the_model(codecs):
    """ResShallow rebuilt from the front weight matrices gives the model's
    own logits, bit for bit, on a whole padded volume."""
    import torch
    port, _, res = codecs
    net = port._network_engine()
    vol = torch.from_numpy(np.random.default_rng(3).choice(
        port.centers, (2, 1, 8, 13, 14)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(net(vol), res(vol))
    assert not any(p.requires_grad for p in net.parameters())
    assert port.thread_clone()._network_engine() is net


def test_logits_match_the_jax_packages(codecs):
    port, ref, _ = codecs
    rng = np.random.default_rng(5)
    blocks = rng.choice(port.centers, (64,) + port.ctx_shape).astype(
        np.float32)
    blocks[::7] = port.pad_value                # all-padding blocks too
    got = port._block_logits_batch(blocks)
    want = np.asarray(ref._block_logits_batch(jax.numpy.asarray(blocks)))
    assert got.shape == (64, L) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    for block in blocks[:12]:
        np.testing.assert_allclose(
            port._block_logits(block),
            np.asarray(ref._block_logits(jax.numpy.asarray(block))),
            rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_front_logits_match_on_a_real_pass(codecs):
    """The blocks a mode-1 pass really feeds the network, gathered from the
    buffer as it fills, against JAX's batched logits."""
    port, ref, _ = codecs
    symbols = _symbols(1, (3, 4, 9))
    seen = []
    net_fn = port._block_logits_batch

    def spy(blocks):
        out = net_fn(blocks)
        seen.append((blocks.copy(), out))
        return out

    list(port._wavefront_pass(symbols.shape, _known(symbols), spy))
    for blocks, got in seen:
        want = np.asarray(ref._block_logits_batch(jax.numpy.asarray(blocks)))
        np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)


# -- round trips ---------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_round_trips_exactly_at_odd_shapes(codecs, shape, mode):
    port, _, _ = codecs
    symbols = _symbols(sum(shape), shape)
    stream = port.encode(symbols, mode=mode)
    assert stream[:4] == b"DTPC" and stream[5] == codec_lib._MODES[mode]
    assert port.encode(symbols, mode=mode) == stream
    np.testing.assert_array_equal(port.decode(stream), symbols)
    gap = port.coding_gap(symbols, stream)
    assert gap["ideal_bits"] == round(port.ideal_bits(symbols, mode), 3)
    assert gap["gap_bits"] >= -32


def test_batch_paths_serve_every_mode(codecs):
    port, _, _ = codecs
    vols = [_symbols(1, (2, 3, 5)), _symbols(2, (3, 2, 4))]
    for mode in ("sequential", "wavefront", "wavefront_np", "wavefront_pl"):
        streams = port.encode_batch(vols, mode=mode)
        assert streams == [port.encode(v, mode=mode) for v in vols]
        for got, want in zip(port.decode_batch(streams), vols):
            np.testing.assert_array_equal(got, want)


def test_mode0_encode_equals_the_sequential_buffers(codecs):
    """A hand-written walk of the padded buffer in raster order, one block
    through the network per position, gives the same stream."""
    port, _, _ = codecs
    symbols = _symbols(4, (2, 4, 6))
    d, h, w = symbols.shape
    p = port.pad
    cd, cs, _ = port.ctx_shape
    buf = np.full((d + p, h + 2 * p, w + 2 * p), port.pad_value, np.float32)
    starts, freqs = [], []
    for dd in range(d):
        for hh in range(h):
            for ww in range(w):
                logits = port._block_logits(
                    buf[dd:dd + cd, hh:hh + cs, ww:ww + cs]).astype(
                        np.float64)
                pmf = np.exp(logits - logits.max())
                f = rans.quantize_pmf(pmf / pmf.sum(), port.scale_bits)
                s = int(symbols[dd, hh, ww])
                starts.append(int(rans.cum_from_freqs(f)[s]))
                freqs.append(int(f[s]))
                buf[dd + p, hh + p, ww + p] = port.centers[s]
    header = b"DTPC" + struct.pack("<BBBHHH", 2, 0, port.scale_bits, d, h, w)
    want = header + rans.encode(np.array(starts, np.uint32),
                                np.array(freqs, np.uint32), port.scale_bits)
    assert port.encode(symbols, mode="sequential") == want


def test_mode1_pads_each_front_to_the_next_power_of_two(codecs):
    """Encode and decode feed the network the same batch sizes, each the
    front's size rounded up to a power of two (capped at the largest
    front), as the JAX engine's bucket rule."""
    port, _, _ = codecs
    symbols = _symbols(6, (4, 5, 7))
    fronts = port._wavefronts(*symbols.shape)
    top = max(len(f) for f in fronts)
    want = [min(1 << (len(f) - 1).bit_length(), top) for f in fronts]
    sizes = []
    net_fn = port._block_logits_batch
    port._block_logits_batch = lambda b: (sizes.append(len(b)),
                                          net_fn(b))[1]
    try:
        stream = port.encode(symbols, mode="wavefront")
        enc_sizes, sizes[:] = list(sizes), []
        port.decode(stream)
    finally:
        del port._block_logits_batch
    assert enc_sizes == sizes == want
    assert [codec_lib.front_bucket(len(f), top) for f in fronts] == want


# -- against the JAX package -----------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_ideal_bits_match_the_jax_packages(codecs, mode):
    port, ref, _ = codecs
    for shape in ODD_SHAPES:
        symbols = _symbols(sum(shape) + 1, shape)
        got = port.ideal_bits(symbols, mode=mode)
        want = ref.ideal_bits(symbols, mode=mode)
        assert abs(got - want) <= 1e-3 * want


def _tables(codec, symbols, mode):
    """Every position's integer table in stream order, (n, L) int64."""
    if mode == "sequential":
        return np.stack([f for _, _, _, f in codec._scan(
            symbols.shape, lambda pos, cum, freqs: int(symbols[pos]))]
        ).astype(np.int64)
    return np.concatenate([f for _, _, _, f in codec._wavefront_pass(
        symbols.shape, _known(symbols))]).astype(np.int64)


@pytest.mark.parametrize("mode", MODES)
def test_the_cross_package_contract(codecs, mode):
    """Same-process contract, with the measured disagreement bounded: over
    the volumes below at most 1% of positions carry a table that differs
    from the JAX engine's, by at most MAX_TABLE_DELTA units; a volume whose
    tables all agree (at least 4 of the 12) gives byte-identical streams,
    decoded by either package."""
    port, ref, _ = codecs
    positions = differing = agreeing_volumes = 0
    for shape in CROSS_SHAPES:
        for seed in range(3):
            symbols = _symbols(seed + sum(shape), shape)
            mine, theirs = (_tables(port, symbols, mode),
                            _tables(ref, symbols, mode))
            delta = np.abs(mine - theirs)
            assert delta.max() <= MAX_TABLE_DELTA
            positions += len(mine)
            differing += int((delta > 0).any(axis=1).sum())
            stream = port.encode(symbols, mode=mode)
            np.testing.assert_array_equal(port.decode(stream), symbols)
            if not delta.any():
                agreeing_volumes += 1
                assert stream == ref.encode(symbols, mode=mode)
                np.testing.assert_array_equal(ref.decode(stream), symbols)
    assert differing <= 0.01 * positions
    assert agreeing_volumes >= 4


# -- refusals --------------------------------------------------------------------

@pytest.mark.parametrize("mode", [0, 1])
def test_truncated_mode0_and_mode1_payloads_raise_typed(codecs, mode):
    port, _, _ = codecs
    header = b"DTPC" + struct.pack("<BBBHHH", 2, mode, 16, 2, 3, 4)
    with pytest.raises(ValueError, match="truncated rANS"):
        port.decode(header + b"\0\0")
