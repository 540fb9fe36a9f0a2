"""The port's coding building blocks against the JAX package's: the rANS
coder (native, plain Python, JAX package), the integrity copy, the weight
matrices and the numpy incremental engine, and K3's plain version.

Tolerances: rANS streams and decoded symbols are compared byte for byte;
the incremental engine's logits bit for bit (the same numpy code on the
same float32 matrices); K3's plain torch version against the Pallas kernel
in interpret mode within rtol/atol 1e-5, the slack
tests/test_probclass_pallas.py:49 allows between Pallas and XLA (the two
sum the same fp32 products in another order).
"""

import os

import jax
import numpy as np
import pytest
import torch

from dsin_tpu.coding import incremental as jax_incremental
from dsin_tpu.coding import probclass_pallas as jax_pallas
from dsin_tpu.coding import rans as jax_rans
from dsin_tpu.config import parse_config as jax_parse
from dsin_tpu.models import probclass as jax_pc
from dsin_tpu.utils import integrity as jax_integrity
from dsin_tpu_torch import bridge, native_build
from dsin_tpu_torch.coding import incremental
from dsin_tpu_torch.coding import probclass_kernel as pk
from dsin_tpu_torch.coding import rans
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models import probclass as pc_lib
from dsin_tpu_torch.utils import integrity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 6


def _lane(rng, n, num_syms=L):
    """(starts, freqs, symbols, cums) of n symbols under fresh PMFs."""
    freqs = rans.quantize_pmf_batch(rng.dirichlet(np.full(num_syms, 0.5),
                                                  size=n))
    cums = rans.cum_from_freqs_batch(freqs)
    symbols = rng.integers(0, num_syms, n)
    ar = np.arange(n)
    return cums[ar, symbols], freqs[ar, symbols], symbols, cums


# -- the coder ----------------------------------------------------------------

def test_range_coder_source_is_a_byte_copy():
    with open(os.path.join(REPO, "dsin_tpu", "coding", "native",
                           "range_coder.cpp"), "rb") as f:
        assert rans.SOURCE.read_bytes() == f.read()


@pytest.mark.parametrize("n", [0, 1, 7, 500])
def test_encode_native_python_and_jax_are_byte_identical(n):
    starts, freqs, _, _ = _lane(np.random.default_rng(n), n)
    native = rans.encode(starts, freqs)
    assert native == rans.encode_py(starts, freqs)
    assert native == jax_rans.encode(starts, freqs)


@pytest.mark.parametrize("lane_lens", [[0, 1, 17, 256], [1], [0, 0],
                                       [64, 64, 64]])
def test_encode_batch_matches_single_python_and_jax(lane_lens):
    rng = np.random.default_rng(len(lane_lens))
    lanes = [_lane(rng, n) for n in lane_lens]
    starts, freqs = [ln[0] for ln in lanes], [ln[1] for ln in lanes]
    rans.reset_native_call_counts()
    batch = rans.encode_batch(starts, freqs)
    assert rans.native_call_counts() == {"encode_batch": 1}
    assert batch == [rans.encode(s, f) for s, f in zip(starts, freqs)]
    assert batch == [rans.encode_py(s, f) for s, f in zip(starts, freqs)]
    assert batch == jax_rans.encode_batch(starts, freqs)


def test_decoders_native_python_and_jax_agree():
    starts, freqs, symbols, cums = _lane(np.random.default_rng(3), 400)
    stream = rans.encode(starts, freqs)
    with rans.Decoder(stream) as dec:
        got = np.concatenate([dec.decode_front(cums[:150]),
                              [dec.decode_symbol(cums[150])],
                              dec.decode_front(cums[151:])])
    py = rans.PyDecoder(stream).decode_front(cums)
    with jax_rans.Decoder(stream) as jdec:
        want = jdec.decode_front(cums)
    np.testing.assert_array_equal(got, symbols)
    np.testing.assert_array_equal(py, symbols)
    np.testing.assert_array_equal(want, symbols)


def test_decode_static_native_and_python_agree():
    rng = np.random.default_rng(4)
    f = rans.quantize_pmf(rng.dirichlet(np.ones(L)))
    cum = rans.cum_from_freqs(f)
    symbols = rng.integers(0, L, 300)
    stream = rans.encode(cum[symbols], f[symbols])
    with rans.Decoder(stream) as dec:
        np.testing.assert_array_equal(dec.decode_static(cum, 300), symbols)
    np.testing.assert_array_equal(
        rans.PyDecoder(stream).decode_static(cum, 300), symbols)


def test_decode_front_batch_matches_per_decoder_and_jax():
    """Ragged lanes (one empty) over two fronts: one native call a front,
    the same symbols as separate decoders and as the JAX package's batch."""
    rng = np.random.default_rng(5)
    lens = [(3, 5), (0, 2), (7, 1)]
    lanes = [_lane(rng, a + b) for a, b in lens]
    streams = rans.encode_batch([ln[0] for ln in lanes],
                                [ln[1] for ln in lanes])
    decs = [rans.Decoder(s) for s in streams]
    jdecs = [jax_rans.Decoder(s) for s in streams]
    for front in range(2):
        cums = [ln[3][:a] if front == 0 else ln[3][a:]
                for ln, (a, _) in zip(lanes, lens)]
        rans.reset_native_call_counts()
        got = rans.decode_front_batch(decs, cums)
        assert rans.native_call_counts() == {"decode_batch": 1}
        want = jax_rans.decode_front_batch(jdecs, cums)
        for g, w, ln, (a, _) in zip(got, want, lanes, lens):
            sl = slice(0, a) if front == 0 else slice(a, None)
            np.testing.assert_array_equal(g, ln[2][sl])
            np.testing.assert_array_equal(g, w)


def test_decode_front_batch_takes_native_decoders_only():
    stream = rans.encode(*_lane(np.random.default_rng(6), 4)[:2])
    with pytest.raises(TypeError, match="native"):
        rans.decode_front_batch([rans.PyDecoder(stream)], [np.zeros((1, 7))])


def test_capacity_retry_is_byte_identical_then_raises_typed(monkeypatch):
    starts, freqs, _, _ = _lane(np.random.default_rng(7), 300)
    want = rans.encode(starts, freqs)
    monkeypatch.setattr(rans, "_encode_cap", lambda n: 16)
    assert rans.encode(starts, freqs) == want
    assert rans.encode_batch([starts], [freqs]) == [want]
    monkeypatch.setattr(rans, "_CAP_DOUBLINGS", 2)
    with pytest.raises(rans.RansCapacityError):
        rans.encode(starts, freqs)
    with pytest.raises(rans.RansCapacityError):
        rans.encode_batch([starts], [freqs])


def test_coder_validates_its_input():
    with pytest.raises(ValueError, match=">= 1"):
        rans.encode([0, 1], [1, 0])
    with pytest.raises(ValueError, match="mismatch"):
        rans.encode([0, 1], [1])
    with pytest.raises(ValueError, match="truncated"):
        rans.Decoder(b"\x00\x01")


def test_failed_build_raises(monkeypatch, tmp_path):
    """A failed g++ build raises with the compiler's output: no fallback to
    the Python coder."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.build(bad, native_build.gxx(), rans.GXX_FLAGS, "broken")
    monkeypatch.setattr(native_build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_build.gxx()


def test_quantization_matches_jax():
    rng = np.random.default_rng(8)
    pmfs = rng.dirichlet(np.full(L, 0.3), size=2000)
    pmfs[:5] = [[1, 0, 0, 0, 0, 0], [0] * 6, [np.nan] * 6,
                [1e-12] * 5 + [1.0], [0.5] * 6]
    freqs = rans.quantize_pmf_batch(pmfs)
    np.testing.assert_array_equal(freqs, jax_rans.quantize_pmf_batch(pmfs))
    assert (freqs.sum(axis=1) == 1 << 16).all() and freqs.min() >= 1
    np.testing.assert_array_equal(rans.quantize_pmf(pmfs[7]),
                                  jax_rans.quantize_pmf(pmfs[7]))
    np.testing.assert_array_equal(rans.cum_from_freqs_batch(freqs),
                                  jax_rans.cum_from_freqs_batch(freqs))


# -- integrity ---------------------------------------------------------------

def test_integrity_copy_agrees():
    chunks = (b"DSIM", b"\x03\x00", bytes(range(200)))
    assert integrity.frame_crc(*chunks) == jax_integrity.frame_crc(*chunks)
    crc = integrity.frame_crc(*chunks)
    integrity.verify_crc(crc, "x", *chunks)
    with pytest.raises(integrity.IntegrityError, match="CRC mismatch"):
        integrity.verify_crc(crc ^ 1, "x", *chunks)
    assert issubclass(integrity.IntegrityError, ValueError)


# -- weights, the incremental engine and K3's plain version ------------------

@pytest.fixture(scope="module")
def bridged():
    """The tiny config's context model: JAX ResShallow params (seeded
    init, biases perturbed so they count) and the port's ResShallow on the
    bridged weights, plus seeded sorted centers."""
    _, pc = tiny_configs()
    jcfg = jax_parse(str(pc))
    jpc = jax_pc.ResShallow(jcfg, L)
    params = jax.tree_util.tree_map(np.asarray, jpc.init(
        jax.random.PRNGKey(3), np.zeros((1, 5, 9, 9, 1), np.float32))
        ["params"])
    rng = np.random.default_rng(3)
    for layer in params.values():
        layer["bias"] = rng.normal(0, 0.1, layer["bias"].shape).astype(
            np.float32)
    res = pc_lib.ResShallow(pc, L)
    state = bridge.state_dict_from_jax({"probclass": params}, {})
    res.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()},
                        strict=True)
    centers = np.sort(rng.uniform(-2, 2, L)).astype(np.float32)
    return jcfg, params, res, centers


def test_context_shape():
    assert pc_lib.context_shape(3) == (5, 9, 9)
    assert pc_lib.context_shape(5) == (9, 17, 17)


def test_weight_matrices_equal_the_jax_engines(bridged):
    """Pre-masked (taps*Cin, Cout) matrices in (td, th, tw, cin) row order,
    equal to what both JAX engines build from the flax params."""
    jcfg, params, res, centers = bridged
    jeng = jax_incremental.IncrementalResShallow(params, centers, jcfg, 0.0)
    kernel = jax_pallas.ProbclassFrontKernel(params, jcfg)
    mats = pc_lib.front_weight_matrices(res)
    assert [w.shape for w, _ in mats] == [(18, 12), (216, 12), (216, 12),
                                          (216, 6)]
    for i, (w, b) in enumerate(mats):
        assert w.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(w, jeng.W[i])
        np.testing.assert_array_equal(b, jeng.b[i])
        np.testing.assert_array_equal(w, np.asarray(kernel._weights[2 * i]))
    # the masked taps are zero rows: the last depth slice's centre (conv0
    # only), right of centre and the row below
    assert not mats[0][0][13].any() and mats[0][0][12].any()
    assert not mats[1][0][14 * 12:15 * 12].any()


@pytest.mark.parametrize("shape", [(8, 5, 6), (3, 4, 9)])
def test_incremental_logits_bit_equal_to_jax(bridged, shape):
    """Both engines over one volume pass: every front's logits bit-equal."""
    jcfg, params, res, centers = bridged
    pad = float(centers[0])
    jeng = jax_incremental.IncrementalResShallow(params, centers, jcfg, pad)
    eng = incremental.IncrementalResShallow(
        pc_lib.front_weight_matrices(res), centers, 3, pad)
    symbols = np.random.default_rng(9).integers(0, L, shape)
    jvp, vp = jeng.begin(shape), eng.begin(shape)
    assert len(vp.sch.fronts) == len(jvp.sch.fronts)
    for i, ((t, front), (jt, jfront)) in enumerate(zip(vp.sch.fronts,
                                                       jvp.sch.fronts)):
        assert t == jt
        np.testing.assert_array_equal(front, jfront)
        got = vp.logits_for(i)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jvp.logits_for(i))
        s = symbols[front[:, 0], front[:, 1], front[:, 2]]
        vp.write(i, s)
        jvp.write(i, s)


def _torch_weights(res):
    return [(torch.from_numpy(w), torch.from_numpy(b))
            for w, b in pc_lib.front_weight_matrices(res)]


@pytest.mark.parametrize("batch", [1, 5, 130])
def test_k3_plain_matches_pallas_interpret(bridged, batch):
    """Blocks drawn from the centers (130 > the Pallas 128-row tile, so its
    multi-tile grid and padding run too)."""
    jcfg, params, res, centers = bridged
    blocks = np.random.default_rng(batch).choice(
        centers, size=(batch, 5, 9, 9)).astype(np.float32)
    kernel = jax_pallas.ProbclassFrontKernel(params, jcfg, interpret=True)
    want = np.asarray(kernel.front_logits(blocks))
    pk.reset_launch_counts()
    got = pk.probclass_front_logits(torch.from_numpy(blocks),
                                    _torch_weights(res))
    assert pk.launch_counts == {"probclass_front_logits": 0}   # CPU: plain
    assert got.dtype == torch.float32 and tuple(got.shape) == (batch, L)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_k3_plain_matches_the_models_conv3d(bridged):
    """The tap loop equals ResShallow's masked conv3d over one context
    block (the model's own function of the block), within 1e-5."""
    _, _, res, centers = bridged
    blocks = np.random.default_rng(1).choice(
        centers, size=(9, 5, 9, 9)).astype(np.float32)
    x = torch.from_numpy(blocks)
    with torch.no_grad():
        want = res(x[:, None]).reshape(9, L)
    got = pk.probclass_front_logits_reference(x, _torch_weights(res))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_k3_wrapper_checks_its_operands(bridged):
    weights = _torch_weights(bridged[2])
    blocks = torch.zeros((2, 5, 9, 9))
    with pytest.raises(TypeError, match="float32"):
        pk.probclass_front_logits(blocks.double(), weights)
    with pytest.raises(ValueError, match="kernel_size 3"):
        pk.probclass_front_logits(torch.zeros((2, 5, 9, 10)), weights)
    with pytest.raises(ValueError, match="layer 1"):
        pk.probclass_front_logits(blocks, [weights[0], weights[0]]
                                  + weights[2:])
    with pytest.raises(ValueError, match="contiguous"):
        pk.probclass_front_logits(torch.zeros((2, 9, 9, 5)).permute(
            0, 3, 1, 2), weights)


def test_k3_non_cpu_tensors_never_reach_the_plain_version(bridged):
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises (here: 'meta' tensors raise before any launch)."""
    weights = [(w.to("meta"), b.to("meta")) for w, b in
               _torch_weights(bridged[2])]
    pk.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        pk.probclass_front_logits(torch.zeros((2, 5, 9, 9), device="meta"),
                                  weights)
    assert pk.launch_counts == {"probclass_front_logits": 0}
