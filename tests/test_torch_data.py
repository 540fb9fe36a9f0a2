"""The port's data pipe and test run against the JAX package: PNG files
without PIL (`data/png.py`), the synthetic corpus, the pair loader's center
crops, the score lists, and the test entry point `dsin_tpu_torch.main` on a
two-pair tiny split against the JAX package's own test loop on the same
checkpoint and data.

Bounds: PNG pixels, corpora, crops and written lists are exact. The test
run: real bpp equal under mode 2 (the streams are byte-identical across the
packages); the estimated bpp within rtol 1e-5 and the reconstruction scores
(L1, PSNR, MS-SSIM on the uint8-truncated images) within 1e-3 relative, as
the float32 nets agree to 1e-3 of 255 and a pixel that straddles an integer
truncates to its neighbour (tests/test_torch_slice_entry.py's bounds).
"""

import io
import os
import struct
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from dsin_tpu.config import parse_config as jax_parse_config
from dsin_tpu.data import loader as jax_data
from dsin_tpu.data import synthetic as jax_synthetic
from dsin_tpu.eval import reporting as jax_reporting
from dsin_tpu.main import Experiment as JaxExperiment
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu.ops.sifinder import gaussian_position_mask
from dsin_tpu.train import checkpoint as jax_ckpt
from dsin_tpu.train import step as jax_step
from dsin_tpu_torch import main as port_main
from dsin_tpu_torch.data import loader as port_data
from dsin_tpu_torch.data import png
from dsin_tpu_torch.data import synthetic as port_synthetic
from dsin_tpu_torch.data.manifest import read_pair_manifest
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.eval import reporting as port_reporting
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.train import checkpoint as port_ckpt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smooth(seed, h=37, w=53):
    rng = np.random.default_rng(seed)
    img = np.cumsum(rng.normal(0, 9, (h, w, 3)), axis=1) + 128
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_bytes(im) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


# -- PNG ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_reads_what_pil_writes(mode):
    base = Image.fromarray(_smooth(1))
    im = base.quantize(200) if mode == "P" else base.convert(mode)
    data = _pil_bytes(im)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _chunk(ctype, payload):
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))


def _filter_row(kind, row, prev, bpp):
    """PNG filter `kind` of one scanline (uint8 arrays)."""
    r, p = row.astype(np.int32), prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]])
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = p
    elif kind == 3:
        pred = (a + p) // 2
    else:
        est = a + p - c
        pa, pb, pc = np.abs(est - a), np.abs(est - p), np.abs(est - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) & 0xFF).astype(np.uint8)


def _handmade_png(img, kinds, colour=2, depth=8, interlace=0):
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch)
    prev = np.zeros(w * ch, np.uint8)
    scan = b""
    for r in range(h):
        kind = kinds[r % len(kinds)]
        scan += bytes([kind]) + _filter_row(kind, rows[r], prev, ch).tobytes()
        prev = rows[r]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return (png.SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(scan)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,),
                                   (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "all"])
def test_reads_every_row_filter(kinds):
    img = _smooth(2)
    data = _handmade_png(img, kinds)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img)
    np.testing.assert_array_equal(png.decode_png(data), img)


def test_pil_reads_what_the_port_writes(tmp_path):
    img = _smooth(3, 64, 90)
    png.write_png(img, str(tmp_path / "a.png"))
    with Image.open(tmp_path / "a.png") as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "a.png")), img)


def test_what_it_does_not_read_raises():
    img = _smooth(4, 8, 8)
    sixteen = _pil_bytes(Image.fromarray(
        (img[..., 0].astype(np.uint16) * 257)).convert("I;16"))
    with pytest.raises(png.PngError, match="bit depth 16"):
        png.decode_png(sixteen)
    with pytest.raises(png.PngError, match="interlaced"):
        png.decode_png(_handmade_png(img, (0,), interlace=1))
    good = bytearray(png.encode_png(img))
    good[40] ^= 0xFF                                # inside IDAT
    with pytest.raises(png.PngError, match="CRC"):
        png.decode_png(bytes(good))
    with pytest.raises(png.PngError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(20))
    with pytest.raises(png.PngError, match="uint8"):
        png.encode_png(img.astype(np.float32))


# -- corpus, loader, reporting ------------------------------------------------

def test_synthetic_corpus_equals_jax(tmp_path):
    args = dict(num_train=1, num_val=1, num_test=2, height=24, width=40,
                seed=7)
    mine = port_synthetic.write_corpus(str(tmp_path / "p"), **args)
    theirs = jax_synthetic.write_corpus(str(tmp_path / "j"), **args)
    assert sorted(mine) == sorted(theirs)
    for split in mine:
        assert open(mine[split]).read() == open(theirs[split]).read()
        for rel in open(mine[split]).read().split():
            np.testing.assert_array_equal(
                png.read_png(str(tmp_path / "p" / rel)),
                jax_data.decode_image(str(tmp_path / "j" / rel)))


def test_center_crops_equal_jax(tmp_path):
    manifests = port_synthetic.write_corpus(
        str(tmp_path), num_train=0, num_val=0, num_test=3, height=36,
        width=60, seed=2)
    pairs = read_pair_manifest(manifests["test"], root=str(tmp_path))
    kw = dict(crop_size=(24, 40), batch_size=1, train=False)
    mine = list(port_data.PairDataset(pairs, **kw).batches())
    theirs = list(jax_data.PairDataset(pairs, **kw).batches())
    assert len(mine) == len(theirs) == 3
    for (x, y), (jx, jy) in zip(mine, theirs):
        assert x.dtype == jx.dtype == np.float32
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_score_lists_equal_jax(tmp_path):
    rng = np.random.default_rng(8)
    lists = {}
    for name, mod in (("p", port_reporting), ("j", jax_reporting)):
        sl = mod.ScoreLists(str(tmp_path / name), "m")
        for i in range(2):
            x = rng.uniform(0, 255, (40, 48, 3)).astype(np.float32)
            out = np.clip(x + rng.normal(0, 5, x.shape), 0, 255)
            sl.add_image(x, out, bpp=0.1 * i, y_syn=out[::-1].copy(),
                         patch_size=(20, 24), real_bpp=0.2 + i)
            sl.save()
        mod.save_image(out, mod.image_output_path(str(tmp_path / name), 1,
                                                  0.25))
        lists[name] = sl
        rng = np.random.default_rng(8)
    for metric in port_reporting.ScoreLists.METRICS:
        fname = f"{metric}_list_m.txt"
        assert (open(tmp_path / "p" / fname).read()
                == open(tmp_path / "j" / fname).read()), metric
    np.testing.assert_array_equal(
        png.read_png(str(tmp_path / "p" / "1_0.2500bpp.png")),
        np.asarray(Image.open(tmp_path / "j" / "1_0.2500bpp.png")))


# -- the test run -------------------------------------------------------------

def _test_configs(root, load_name):
    ae, pc = tiny_configs()
    ae = ae.replace(eval_crop_size=(40, 48), load_model=True,
                    load_train_step=False, train_model=False,
                    test_model=True, load_model_name=load_name,
                    root_data=str(root), file_path_test="test.txt",
                    file_path_train="train.txt", do_flips=False)
    return ae, pc


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A two-pair tiny test split at 48x64 (center-cropped to 40x48) and a
    checkpoint written by the JAX package's save_checkpoint."""
    root = tmp_path_factory.mktemp("split")
    manifests = port_synthetic.write_corpus(
        str(root), num_train=0, num_val=0, num_test=2, height=48, width=64,
        seed=4)
    os.rename(manifests["test"], root / "test.txt")
    ae, pc = _test_configs(root, "m")
    source = build_model(ae, pc, device="cpu", seed=9)
    state = port_ckpt.state_from_model(source)
    jstate = jax_step.TrainState(params=state.params,
                                 batch_stats=state.batch_stats,
                                 opt_state=(), step=jnp.int32(3))
    jax_ckpt.save_checkpoint(str(root / "weights" / "m"), jstate,
                             manifest_extra={
                                 "pc_config_sha256": jax_ckpt.config_sha256(
                                     jax_parse_config(str(pc))), "seed": 9})
    return root, ae, pc


def _jax_test_run(root, ae, pc, out):
    """The JAX package's Experiment test loop (maybe_restore, test) on the
    same split and checkpoint, built without its trainer: its __init__ traces
    the train state eagerly, minutes on the CPU."""
    jae, jpc = jax_parse_config(str(ae)), jax_parse_config(str(pc))
    exp = JaxExperiment.__new__(JaxExperiment)
    exp.ae_config, exp.pc_config = jae, jpc
    exp.model = JaxDSIN(jae, jpc)
    zeros = port_ckpt.state_from_model(build_model(ae, pc, device="cpu",
                                                   seed=0))
    exp.state = jax_step.TrainState(params=zeros.params,
                                    batch_stats=zeros.batch_stats,
                                    opt_state=(), step=jnp.int32(0))
    exp.infer_step = jax_step.make_inference_step(
        exp.model, si_mask=jnp.asarray(gaussian_position_mask(40, 48, 20,
                                                              24)))
    exp.model_name = "jax"
    exp.weights_root = str(root / "weights")
    exp.images_dir = str(out)
    exp.maybe_restore()
    return exp.test(real_bpp=True)


def test_the_test_run_scores_as_jax(split, tmp_path):
    root, ae, pc = split
    (tmp_path / "weights").symlink_to(root / "weights")
    seen = []
    results = port_main.run(
        ae, pc, out_root=str(tmp_path), real_bpp=True, device="cpu",
        on_image=lambda exp, i, rec: seen.append((exp, i, rec)))
    exp = seen[0][0]
    assert [i for _, i, _ in seen] == [0, 1]
    assert exp.restore_ms is not None and exp.eval_mask.factors is not None
    jax_results = _jax_test_run(root, ae, pc, tmp_path / "jax_images")

    def lists(out_dir, name):
        return {m: port_reporting.ScoreLists.load_list(out_dir, m, name)
                for m in ("bpp", "real_bpp", "l1", "psnr", "ms_ssim")}

    mine = lists(exp.images_dir, exp.model_name)
    theirs = lists(str(tmp_path / "jax_images"), "jax")
    assert all(len(v) == 2 for v in mine.values())
    np.testing.assert_array_equal(mine["real_bpp"], theirs["real_bpp"])
    np.testing.assert_allclose(mine["bpp"], theirs["bpp"], rtol=1e-5)
    for m in ("l1", "psnr", "ms_ssim"):
        np.testing.assert_allclose(mine[m], theirs[m], rtol=1e-3, err_msg=m)
    assert set(results) == set(jax_results)
    pngs = sorted(n for n in os.listdir(exp.images_dir) if n.endswith(".png"))
    assert len(pngs) == 2
    for _, i, rec in seen:
        want = np.clip(rec["out"]["x_with_si"][0], 0, 255).astype(np.uint8)
        name = f"{i}_{float(rec['out']['bpp']):.4f}bpp.png"
        np.testing.assert_array_equal(
            png.read_png(os.path.join(exp.images_dir, name)), want)


def test_the_cli_runs_a_test_only_config(split, tmp_path, capsys):
    """`python -m dsin_tpu_torch.main` with a test-only config restores
    the checkpoint and writes the score lists, real bpp among them."""
    root, ae, _ = split
    ae_path = tmp_path / "ae_test"
    ae_path.write_text(str(ae))
    pc_path = tmp_path / "pc_test"
    pc_path.write_text(str(split[2]))
    (tmp_path / "weights").symlink_to(root / "weights")
    port_main.main(["-ae_config", str(ae_path), "-pc_config", str(pc_path),
                    "--out_root", str(tmp_path), "--real_bpp",
                    "--device", "cpu", "--max_test_images", "1"])
    assert "done:" in capsys.readouterr().out
    (images,) = os.listdir(tmp_path / "images")
    real = port_reporting.ScoreLists.load_list(
        str(tmp_path / "images" / images), "real_bpp", images)
    est = port_reporting.ScoreLists.load_list(
        str(tmp_path / "images" / images), "bpp", images)
    assert len(real) == 1 and 0 < real[0] < 3 * est[0] + 1


def test_what_waits_for_training_raises(split, tmp_path):
    """Training is ported (tests/test_torch_train_loop.py); what waits for
    later slices raises, naming its ROADMAP item."""
    root, ae, pc = split
    with pytest.raises(NotImplementedError, match="multi-device training"):
        port_main.run(ae.replace(train_model=True, spatial_shards=2), pc,
                      device="cpu")
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1, multi-device training"):
        port_main.main(["--distributed", "--device", "cpu"])
    exp = port_main.Experiment(ae, pc, out_root=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="matplotlib"):
        exp.test(save_plots=True)


def test_the_codec_cli_runs_without_pil(tmp_path):
    """`coding/cli.py compress / decompress` with PIL made unimportable, as
    on the card machine."""
    img = _smooth(5, 40, 48)
    png.write_png(img, str(tmp_path / "x.png"))
    ae, pc = tiny_configs()
    (tmp_path / "ae").write_text(str(ae))
    (tmp_path / "pc").write_text(str(pc))
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "from dsin_tpu_torch.coding import cli\n"
        "flags = ['--ae_config', 'ae', '--pc_config', 'pc', '--device', "
        "'cpu']\n"
        "cli.main(['compress', 'x.png', 'x.dsin'] + flags)\n"
        "cli.main(['decompress', 'x.dsin', 'r.png', '--side', 'x.png'] + "
        "flags)\n"
        "assert 'PIL' not in {m.split('.')[0] for m, v in "
        "sys.modules.items() if v is not None}\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert png.read_png(str(tmp_path / "r.png")).shape == (40, 48, 3)


def test_restore_best_for_test_picks_the_lowest_best_val(split, tmp_path):
    """Among the run's own checkpoint dir and extra candidates (resolved
    through `.prev-*`), the lowest recorded best_val is restored."""
    _, ae, pc = split
    exp = port_main.Experiment(ae.replace(load_model=False), pc,
                               out_root=str(tmp_path), device="cpu")
    assert exp.restore_best_for_test() is None          # nothing saved yet
    better = build_model(ae, pc, device="cpu", seed=21)
    worse = build_model(ae, pc, device="cpu", seed=22)
    port_ckpt.save_checkpoint(exp.ckpt_dir,
                              port_ckpt.state_from_model(worse, 5),
                              best_val=3.0)
    other = str(tmp_path / "earlier")
    port_ckpt.save_checkpoint(other, port_ckpt.state_from_model(better, 4),
                              best_val=2.0)
    os.rename(other, other + ".prev-000001")   # a kill between the renames
    assert exp.restore_best_for_test([other]) == other + ".prev-000001"
    want = better.state_dict()
    assert all(np.array_equal(v.numpy(), want[k].numpy())
               for k, v in exp.model.state_dict().items())
