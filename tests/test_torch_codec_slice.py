"""The port's codec slice against the JAX package's codec: DTPC streams of
mode 2 byte-identical in both directions, the batch paths, ideal_bits and
coding_gap equal, mode 3 (K3 through its plain version on the CPU) exact
round trips, typed errors, DSIM framing, and the CLI cores on the tiny
configuration.

Tolerances: streams and symbols are compared byte for byte and ideal_bits
exactly (the two packages run the same numpy engine on the same float32
weight matrices); mode 3's ideal_bits within 1e-3 relative of mode 2's (its
logits differ from the numpy engine's in the last ulp, which can move a
quantized frequency by one); reconstructions exactly, against the port's own
model on the same seed.
"""

import os
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dsin_tpu.coding import cli as jax_cli
from dsin_tpu.coding import codec as jax_codec
from dsin_tpu.config import parse_config as jax_parse
from dsin_tpu.models import probclass as jax_pc
from dsin_tpu_torch import bridge
from dsin_tpu_torch.coding import cli
from dsin_tpu_torch.coding import codec as codec_lib
from dsin_tpu_torch.coding import probclass_kernel as pk
from dsin_tpu_torch.coding import rans
from dsin_tpu_torch.coding.loader import load_model_state, make_codec
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models import probclass as pc_lib
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.models.quantizer import centers_lookup
from dsin_tpu_torch.serve.device import DeviceServer
from dsin_tpu_torch.utils.integrity import IntegrityError

L = 6
SHAPE = (8, 5, 6)          # the tiny configuration's 40x48 bottleneck


@pytest.fixture(scope="module")
def codecs():
    """(port codec, JAX codec) on one bridged context model: the tiny
    config's ResShallow with seeded weights (biases perturbed so they
    count) and seeded sorted centers."""
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
    return port, jax_codec.BottleneckCodec(jpc, params, centers, jcfg)


def _symbols(seed, shape=SHAPE):
    return np.random.default_rng(seed).integers(0, L, shape)


# -- mode 2: byte-identical across the packages ------------------------------

@pytest.mark.parametrize("shape", [SHAPE, (3, 4, 9), (1, 1, 1)])
def test_mode2_streams_are_byte_identical_both_ways(codecs, shape):
    port, ref = codecs
    symbols = _symbols(sum(shape), shape)
    stream = port.encode(symbols)
    assert stream == ref.encode(symbols, mode="wavefront_np")
    assert stream[5] == codec_lib.MODE_WAVEFRONT_NP
    np.testing.assert_array_equal(port.decode(stream), symbols)
    np.testing.assert_array_equal(ref.decode(stream), symbols)


def test_mode2_decodes_the_jax_packages_stream(codecs):
    port, ref = codecs
    symbols = _symbols(11)
    np.testing.assert_array_equal(port.decode(ref.encode(symbols)), symbols)


def test_batch_paths_ideal_bits_and_gap_agree_with_jax(codecs):
    port, ref = codecs
    vols = [_symbols(1), _symbols(2), _symbols(3, (2, 3, 4))]
    streams = port.encode_batch(vols)
    assert streams == ref.encode_batch(vols)
    assert streams == [port.encode(v) for v in vols]
    for got, want in zip(port.decode_batch(streams), vols):
        np.testing.assert_array_equal(got, want)
    for v, s in zip(vols, streams):
        assert port.ideal_bits(v) == ref.ideal_bits(v, mode="wavefront_np")
        assert port.coding_gap(v, s) == ref.coding_gap(v, s)
    nhwc = np.stack([np.transpose(v, (1, 2, 0)) for v in vols[:2]])
    blobs = codec_lib.encode_batch(port, nhwc)
    assert blobs == jax_codec.encode_batch(ref, nhwc)
    np.testing.assert_array_equal(codec_lib.decode_batch(port, blobs), nhwc)


def test_decode_batch_of_mixed_modes_and_shapes_decodes_each_stream(codecs):
    """Each stream through its own header's engine: one native rANS call a
    front of each stream, the same volumes as single decodes."""
    port, _ = codecs
    vols = [_symbols(4), _symbols(5, (3, 4, 9)), _symbols(6)]
    streams = [port.encode(vols[0]), port.encode(vols[1]),
               port.encode(vols[2], mode="wavefront_pl")]
    rans.reset_native_call_counts()
    for got, want in zip(port.decode_batch(streams), vols):
        np.testing.assert_array_equal(got, want)
    fronts = sum(len(port._wavefronts(*v.shape)) for v in vols)
    assert rans.native_call_counts() == {"decode_front": fronts}


# -- mode 3: K3 through its plain version on the CPU -------------------------

def test_mode3_round_trips_exactly_on_the_cpu(codecs):
    port, _ = codecs
    symbols = _symbols(12)
    pk.reset_launch_counts()
    stream = port.encode(symbols, mode="wavefront_pl")
    assert stream[:4] == b"DTPC" and stream[5] == 3
    assert port.encode(symbols, mode="wavefront_pl") == stream
    np.testing.assert_array_equal(port.decode(stream), symbols)
    assert pk.launch_counts == {"probclass_front_logits": 0}
    ideal3 = port.ideal_bits(symbols, mode="wavefront_pl")
    ideal2 = port.ideal_bits(symbols)
    assert abs(ideal3 - ideal2) <= 1e-3 * ideal2
    gap = port.coding_gap(symbols, stream)
    assert gap["ideal_bits"] == round(ideal3, 3)
    assert gap["gap_bits"] >= 0


def test_mode3_and_mode2_share_the_wavefront_schedule(codecs):
    port, _ = codecs
    fronts = port._wavefronts(*SHAPE)
    sch = port._incremental_engine().schedule(SHAPE)
    assert len(fronts) == len(sch.fronts) == 25 * 7 + 5 * 4 + 5 + 1
    for f, (_, g) in zip(fronts, sch.fronts):
        np.testing.assert_array_equal(f, g)


# -- typed errors ------------------------------------------------------------

def _header(mode=2, version=2, scale_bits=16, dims=SHAPE):
    return b"DTPC" + struct.pack("<BBBHHH", version, mode, scale_bits, *dims)


@pytest.mark.parametrize("blob,match", [
    (b"", "truncated"),
    (b"DTPC\x02\x02", "truncated"),
    (b"XXXX" + _header()[4:] + b"\0" * 8, "magic"),
    (_header(version=1) + b"\0" * 8, "version"),
    (_header(mode=7) + b"\0" * 8, "unknown scan mode"),
    (_header(scale_bits=12) + b"\0" * 8, "scale_bits"),
    (_header(dims=(0, 5, 6)) + b"\0" * 8, "implausible"),
    (_header() + b"\0\0", "truncated rANS"),
    (_header(mode=0) + b"\0" * 8, "mode 0 \\(sequential\\).*not port"),
    (_header(mode=1) + b"\0" * 8, "mode 1 \\(wavefront\\).*not port"),
])
def test_bad_streams_raise_typed(codecs, blob, match):
    with pytest.raises(ValueError, match=match):
        codecs[0].decode(blob)


def test_unported_and_unknown_modes_raise_typed(codecs):
    port, _ = codecs
    for mode in ("sequential", "wavefront"):
        with pytest.raises(ValueError, match="not port"):
            port.encode(_symbols(0), mode=mode)
        with pytest.raises(ValueError, match="not port"):
            port.ideal_bits(_symbols(0), mode=mode)
    with pytest.raises(ValueError, match="unknown mode"):
        port.encode(_symbols(0), mode="fast")
    for bad in (np.zeros((2, 3)), np.zeros((0, 2, 2)),
                np.full(SHAPE, L)):
        with pytest.raises(ValueError):
            port.encode(bad)


def test_codec_raises_without_a_card(codecs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port, _ = codecs
    with pytest.raises(RuntimeError, match="device='cpu'"):
        codec_lib.BottleneckCodec(port.weights, port.centers,
                                  port.pc_config)


# -- DSIM framing ------------------------------------------------------------

PAYLOAD = bytes(range(37))


def test_dsim_bytes_equal_the_jax_packages():
    blob = cli.frame_dsim(PAYLOAD, 40, 48, 5)
    assert blob == jax_cli.frame_dsim(PAYLOAD, 40, 48, 5)
    assert cli.parse_dsim(blob) == (3, 40, 48, 5, PAYLOAD)
    assert cli.parse_dsim(blob) == jax_cli.parse_dsim(blob)
    v2 = b"DSIM" + struct.pack("<BHHII", 2, 40, 48, 5, len(PAYLOAD)) + PAYLOAD
    assert cli.parse_dsim(v2) == (2, 40, 48, 5, PAYLOAD)


def test_dsim_every_single_bit_flip_raises_typed():
    """Every flip is a typed ValueError; a flip of a field the CRC covers
    (h, w, seed, the CRC itself, the payload) is an IntegrityError."""
    blob = cli.frame_dsim(PAYLOAD, 40, 48, 5)
    for bit in range(len(blob) * 8):
        bad = bytearray(blob)
        bad[bit // 8] ^= 1 << (bit % 8)
        crc_covered = 5 <= bit // 8 < 17 or bit // 8 >= cli.HEADER_LEN
        with pytest.raises(IntegrityError if crc_covered else ValueError):
            cli.parse_dsim(bytes(bad))
    for cut in (0, 4, 16, 20, len(blob) - 1):
        with pytest.raises(ValueError):
            cli.parse_dsim(blob[:cut])


# -- the CLI cores and the loader --------------------------------------------

@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    ae, pc = tiny_configs()
    d = tmp_path_factory.mktemp("cfg")
    (d / "ae").write_text(str(ae))
    (d / "pc").write_text(str(pc))
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (40, 56, 3)).astype(np.float32)
    x = np.clip(base[:, :48] + rng.normal(0, 4, (40, 48, 3)), 0, 255)
    return (str(d / "ae"), str(d / "pc"), ae, pc, x.astype(np.float32),
            base[:, 8:].copy())


def test_seeded_weights_do_not_depend_on_sinet(configs):
    """AE, probclass and centers from one seed are equal with and without
    siNet: an AE-only compress and a decompress with a side image build
    the same codec."""
    ae_path, pc_path = configs[:2]
    with_si = load_model_state(ae_path, pc_path, need_sinet=True, seed=3,
                               device="cpu")
    alone = load_model_state(ae_path, pc_path, need_sinet=False, seed=3,
                             device="cpu")
    assert with_si.sinet is not None and alone.sinet is None
    state = with_si.state_dict()
    for key, value in alone.state_dict().items():
        assert torch.equal(value, state[key]), key


def test_model_output_does_not_depend_on_input_layout(configs):
    """Equal symbols and images in another memory layout (stacked from
    transposed volumes, as decode_batch returns them) give bit-equal
    outputs."""
    _, _, ae, pc, x, _ = configs
    model = build_model(ae, pc, device="cpu", seed=1)
    xs = torch.from_numpy(np.stack([x, x[::-1]]))
    with torch.no_grad():
        enc = model.encode(xs)
        strided = torch.from_numpy(np.stack(
            [np.ascontiguousarray(np.transpose(s, (2, 0, 1)))
             .transpose(1, 2, 0) for s in enc.symbols.numpy()]))
        assert not strided.is_contiguous()
        q = centers_lookup(model.centers, enc.symbols)
        q_strided = centers_lookup(model.centers, strided)
        assert torch.equal(model.decode(q_strided), model.decode(q))
        x_cl = xs.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        assert torch.equal(model.encode(x_cl).z, enc.z)


def test_loader_refuses_a_checkpoint(configs):
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        load_model_state(*configs[:2], ckpt_dir="weights/m", device="cpu")


def test_array_cores_round_trip(configs):
    ae_path, pc_path, ae, pc, x, y = configs
    blob = cli.compress_array(x, ae_path, pc_path, seed=4, device="cpu")
    _, h, w, seed, payload = cli.parse_dsim(blob)
    assert (h, w, seed) == (40, 48, 4)
    model = build_model(ae, pc, device="cpu", seed=4)
    with torch.no_grad():
        symbols = model.encode(torch.from_numpy(x[None])).symbols
        want = model.decode(centers_lookup(model.centers, symbols))
    assert payload == codec_lib.encode_batch(make_codec(model),
                                             symbols.numpy())[0]
    rec = cli.decompress_array(blob, None, ae_path, pc_path, device="cpu")
    assert rec.dtype == np.uint8 and rec.shape == (40, 48, 3)
    np.testing.assert_array_equal(
        rec, np.clip(want[0].numpy(), 0, 255).astype(np.uint8))
    rec_si = cli.decompress_array(blob, y, ae_path, pc_path, device="cpu")
    server = DeviceServer(ae, pc, device="cpu", seed=4)
    want_si = server.decode_si(symbols, server.open_session(y))
    np.testing.assert_array_equal(
        rec_si, np.clip(want_si[0].numpy(), 0, 255).astype(np.uint8))


def test_seed_that_disagrees_with_the_header_is_an_error(configs):
    ae_path, pc_path, _, _, x, _ = configs
    blob = cli.compress_array(x, ae_path, pc_path, seed=4, device="cpu")
    with pytest.raises(ValueError, match="disagrees with the stream header"):
        cli.decompress_array(blob, None, ae_path, pc_path, seed=5,
                             device="cpu")
    with pytest.raises(ValueError, match="divisible by the subsampling"):
        cli.compress_array(x[:36], ae_path, pc_path, device="cpu")


def test_file_wrappers_and_main(configs, tmp_path, capsys):
    from PIL import Image
    ae_path, pc_path, _, _, x, y = configs
    Image.fromarray(x.astype(np.uint8)).save(tmp_path / "x.png")
    Image.fromarray(y.astype(np.uint8)).save(tmp_path / "y.png")
    flags = ["--ae_config", ae_path, "--pc_config", pc_path,
             "--device", "cpu"]
    cli.main(["compress", str(tmp_path / "x.png"), str(tmp_path / "x.dsin"),
              "--seed", "2"] + flags)
    assert "bpp" in capsys.readouterr().out
    cli.main(["decompress", str(tmp_path / "x.dsin"),
              str(tmp_path / "r.png"), "--side", str(tmp_path / "y.png")]
             + flags)
    assert "with side information" in capsys.readouterr().out
    rec = np.asarray(Image.open(tmp_path / "r.png"))
    want = cli.decompress_array((tmp_path / "x.dsin").read_bytes(),
                                cli.read_image(str(tmp_path / "y.png")),
                                ae_path, pc_path, device="cpu")
    np.testing.assert_array_equal(rec, want)
    blob = bytearray((tmp_path / "x.dsin").read_bytes())
    blob[-1] ^= 0x10
    (tmp_path / "bad.dsin").write_bytes(bytes(blob))
    with pytest.raises(SystemExit) as exc:
        cli.main(["decompress", str(tmp_path / "bad.dsin"),
                  str(tmp_path / "b.png")] + flags)
    assert exc.value.code == 2
    assert capsys.readouterr().err.startswith("integrity error:")
    with pytest.raises(SystemExit) as exc:
        cli.main(["decompress", str(tmp_path / "x.dsin"),
                  str(tmp_path / "b.png"), "--seed", "9"] + flags)
    assert exc.value.code == 2
    assert "disagrees" in capsys.readouterr().err


def test_cli_help_states_the_seed_only_interop_rule():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "dsin_tpu_torch.coding.cli",
                           "--help"], cwd=repo, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0
    assert "decodes only in the package that wrote it" in " ".join(
        proc.stdout.split())
