"""The port's manifest tool against the JAX package's: on the same fake
KITTI (standard frames, general-eval sequences) and Cityscapes trees, every
mode and split rule writes manifests byte-equal to the JAX tool's, and the
CLI refuses the same flag combinations with the same message.

Bounds: exact (file bytes, pair lists, SystemExit messages). The trees are
empty files, as tests/test_make_manifests.py builds them.
"""

import os

import pytest

from dsin_tpu.data import make_manifests as jax_mm
from dsin_tpu_torch.data import make_manifests as mm
from dsin_tpu_torch.data.manifest import read_pair_manifest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _touch(d, names):
    os.makedirs(d, exist_ok=True)
    for name in names:
        open(os.path.join(d, name), "wb").close()


def _fake_kitti(root):
    """A few sequences of every subset and split, frames 08..13 (10 and 11
    are the reference stereo rule's; the others prove it ignores them),
    one frame missing its right image."""
    for subset in mm.SUBSETS:
        for split in mm.SPLITS:
            for cam in ("image_2", "image_3"):
                d = os.path.join(root, subset, split, cam)
                _touch(d, [f"{s:06d}_{f:02d}.png" for s in range(3)
                           for f in range(8, 14)])
    os.remove(os.path.join(root, mm.SUBSETS[0], "training", "image_3",
                           "000001_10.png"))


def _fake_kitti_general(root, n_train_seq=2):
    """The reference's 20 general-eval sequences (testing, frames 00..20)
    and a few training sequences, both cameras."""
    for subset, seqs in mm.REFERENCE_GENERAL_EVAL_SEQS.items():
        for cam in ("image_2", "image_3"):
            _touch(os.path.join(root, subset, "testing", cam),
                   [f"{seq}_{f:02d}.png" for seq in seqs for f in range(21)])
            _touch(os.path.join(root, subset, "training", cam),
                   [f"{s:06d}_{f:02d}.png" for s in range(n_train_seq)
                    for f in range(21)])


def _fake_cityscapes(root):
    frames = {"train": [("aachen", "000000_000019"),
                        ("aachen", "000001_000019"),
                        ("bochum", "000000_000019")],
              "val": [("frankfurt", "000000_000294")],
              "test": [("berlin", "000000_000019")]}
    for split, entries in frames.items():
        for city, stem in entries:
            for side in ("left", "right"):
                if (split, city, side) == ("train", "bochum", "right"):
                    continue   # an orphan left frame, skipped
                _touch(os.path.join(root, f"{side}Img8bit", split, city),
                       [f"{city}_{stem}_{side}Img8bit.png"])


TREES = {"kitti": _fake_kitti, "kitti_general": _fake_kitti_general,
         "cityscapes": _fake_cityscapes}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    out = {}
    for name, make in TREES.items():
        out[name] = str(base / name)
        make(out[name])
    return out


def _both(tmp_path, root, flags):
    """Run both tools with `flags` -> {file name: (port bytes, JAX bytes)}."""
    outs = {}
    for tag, tool in (("port", mm), ("jax", jax_mm)):
        d = str(tmp_path / tag)
        tool.main(["--kitti_root", root, "--out_dir", d] + flags)
        outs[tag] = {n: open(os.path.join(d, n), "rb").read()
                     for n in sorted(os.listdir(d))}
    assert sorted(outs["port"]) == sorted(outs["jax"])
    return {n: (outs["port"][n], outs["jax"][n]) for n in outs["port"]}


CASES = [
    ("kitti", ["--mode", "stereo", "--split_rule", "reference"]),
    ("kitti", ["--mode", "stereo", "--split_rule", "random"]),
    ("kitti", ["--mode", "stereo", "--split_rule", "random", "--val_frac",
               "0.3", "--test_frac", "0.1", "--seed", "5"]),
    ("kitti", ["--mode", "general", "--split_rule", "random"]),
    ("kitti", ["--mode", "general", "--split_rule", "random",
               "--max_offset", "3", "--seed", "2"]),
    ("kitti_general", ["--mode", "general", "--split_rule", "reference"]),
    ("kitti_general", ["--mode", "general", "--split_rule", "reference",
                       "--seed", "4"]),
    ("kitti_general", ["--mode", "stereo", "--split_rule", "reference"]),
    ("cityscapes", ["--dataset", "cityscapes"]),
]


@pytest.mark.parametrize("tree,flags", CASES,
                         ids=[f"{t}-{'-'.join(f)}" for t, f in CASES])
def test_manifests_are_byte_equal_to_the_jax_tools(trees, tmp_path, tree,
                                                   flags):
    files = _both(tmp_path, trees[tree], flags)
    assert files
    for name, (port, ref) in files.items():
        assert port == ref, name
    assert any(port for port, _ in files.values())


def test_the_written_pairs_exist_and_read_back(trees, tmp_path):
    root = trees["kitti"]
    mm.main(["--kitti_root", root, "--out_dir", str(tmp_path),
             "--split_rule", "reference"])
    pairs = read_pair_manifest(str(tmp_path / "KITTI_stereo_train.txt"),
                               root=root)
    # 2 subsets x 3 sequences x frames 10 and 11, both directions, less the
    # frame whose right image is missing (twice: forward and swapped)
    assert len(pairs) == 2 * 3 * 2 * 2 - 2
    for x, y in pairs:
        assert os.path.exists(x) and os.path.exists(y)


def test_pair_functions_equal_the_jax_tools(trees):
    root = trees["kitti"]
    assert mm.stereo_pairs(root) == jax_mm.stereo_pairs(root)
    assert mm.general_pairs(root, 2, 3) == jax_mm.general_pairs(root, 2, 3)
    assert mm.reference_stereo_splits(root) == \
        jax_mm.reference_stereo_splits(root)
    groot = trees["kitti_general"]
    assert mm.general_pair_universe(groot, "testing") == \
        jax_mm.general_pair_universe(groot, "testing")
    assert mm.reference_general_splits(groot, 1) == \
        jax_mm.reference_general_splits(groot, 1)
    assert mm.cityscapes_stereo_splits(trees["cityscapes"]) == \
        jax_mm.cityscapes_stereo_splits(trees["cityscapes"])
    pairs = [(f"x{i}", f"y{i}") for i in range(11)]
    assert mm.split_pairs(pairs, 0.2, 0.3, 9) == \
        jax_mm.split_pairs(pairs, 0.2, 0.3, 9)


REFUSALS = [
    ("cityscapes", ["--dataset", "cityscapes", "--mode", "general"]),
    ("cityscapes", ["--dataset", "cityscapes", "--val_frac", "0.1"]),
    ("cityscapes", ["--dataset", "cityscapes", "--max_offset", "3",
                    "--test_frac", "0.1"]),
    ("kitti", ["--split_rule", "reference", "--val_frac", "0.1"]),
    ("kitti", ["--mode", "general", "--max_offset", "3"]),
    ("empty", ["--split_rule", "random"]),
    ("empty", ["--dataset", "cityscapes"]),
]


@pytest.mark.parametrize("tree,flags", REFUSALS,
                         ids=[f"{t}-{'-'.join(f)}" for t, f in REFUSALS])
def test_the_cli_refuses_what_the_jax_cli_refuses(trees, tmp_path, tree,
                                                  flags):
    root = str(tmp_path / "empty") if tree == "empty" else trees[tree]
    os.makedirs(root, exist_ok=True)
    messages = []
    for tool in (mm, jax_mm):
        with pytest.raises(SystemExit) as err:
            tool.main(["--kitti_root", root, "--out_dir",
                       str(tmp_path / "out")] + flags)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert messages[0]
    assert not os.path.exists(tmp_path / "out")


def test_the_module_runs_as_a_script(trees, tmp_path):
    import subprocess
    import sys
    out = tmp_path / "cs"
    proc = subprocess.run(
        [sys.executable, "-m", "dsin_tpu_torch.data.make_manifests",
         "--dataset", "cityscapes", "--kitti_root", trees["cityscapes"],
         "--out_dir", str(out)], capture_output=True, text=True, timeout=60,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(out)) == [f"cityscapes_stereo_{s}.txt"
                                       for s in ("test", "train", "val")]
