"""Generate x/y pair manifests from a KITTI multiview or a Cityscapes tree
(counterpart of the JAX package's `data/make_manifests.py`; the same rules,
the same bytes on the same tree).

The reference ships frozen manifest files (reference data_paths/
KITTI_stereo_{train,val,test}.txt: alternating lines, image_2 = encoder
input x, image_3 = decoder side information y, both relative to the KITTI
root). This tool regenerates them from a local KITTI download:

  * stereo mode: pair image_2/SEQ_FRAME.png with image_3/SEQ_FRAME.png,
    the same instant seen by the left and the right camera (the
    reference's KITTI_stereo lists);
  * general mode: pair frames of the same sequence at a small temporal
    offset, cameras chosen at random: correlated but not co-instant, the
    reference's KITTI_general lists. The generating rule is derived from
    the frozen lists (see `reference_general_splits`); the reference's own
    shuffle is unrecoverable (unseeded RNG), so these lists match the
    reference's in pair universe, split sizes and structure, but the
    seeded shuffle draws a DIFFERENT val/test membership, so metrics on
    these splits are not directly comparable to numbers computed on the
    reference's frozen lists (for that, point the loader at the frozen
    files themselves);
  * `--dataset cityscapes`: left/right pairs in Cityscapes' own
    train/val/test directories (the names `configs/ae_cityscapes_stereo`
    reads).

Expected KITTI tree (any subset of the standard zips):
    <kitti_root>/data_scene_flow_multiview/{training,testing}/image_{2,3}/
    <kitti_root>/data_stereo_flow_multiview/{training,testing}/image_{2,3}/

Pure host code (os and numpy); it reads directory listings only, never an
image.

Usage:
    python -m dsin_tpu_torch.data.make_manifests --kitti_root /data/kitti \
        --out_dir data_paths [--mode stereo|general] \
        [--split_rule reference|random] [--val_frac .2 --test_frac .2] \
        [--max_offset 2] [--seed 0]
    python -m dsin_tpu_torch.data.make_manifests --dataset cityscapes \
        --kitti_root /data/cityscapes --out_dir data_paths
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

SUBSETS = ("data_scene_flow_multiview", "data_stereo_flow_multiview")
SPLITS = ("training", "testing")
_FRAME_RE = re.compile(r"^(\d+)_(\d+)\.png$")


def _scan(kitti_root: str) -> Dict[Tuple[str, str, str], Dict[int, str]]:
    """{(subset, split, seq): {frame: relpath-of-image_2}} for frames that
    exist in BOTH cameras."""
    out: Dict[Tuple[str, str, str], Dict[int, str]] = {}
    for subset in SUBSETS:
        for split in SPLITS:
            d2 = os.path.join(kitti_root, subset, split, "image_2")
            d3 = os.path.join(kitti_root, subset, split, "image_3")
            if not (os.path.isdir(d2) and os.path.isdir(d3)):
                continue
            right = set(os.listdir(d3))
            for name in sorted(os.listdir(d2)):
                m = _FRAME_RE.match(name)
                if not m or name not in right:
                    continue
                seq, frame = m.group(1), int(m.group(2))
                rel = os.path.join(subset, split, "image_2", name)
                out.setdefault((subset, split, seq), {})[frame] = rel
    return out


def stereo_pairs(kitti_root: str) -> List[Tuple[str, str]]:
    """(x=image_2, y=image_3) same-frame stereo pairs, sorted."""
    pairs = []
    for (_, _, _), frames in sorted(_scan(kitti_root).items()):
        for _, rel2 in sorted(frames.items()):
            pairs.append((rel2, rel2.replace("image_2", "image_3")))
    return pairs


def general_pairs(kitti_root: str, max_offset: int = 2,
                  seed: int = 0) -> List[Tuple[str, str]]:
    """Same-sequence pairs at temporal offset 1..max_offset, random camera
    per side (seeded) — the KITTI_general structure."""
    rng = np.random.default_rng(seed)
    pairs = []
    for (_, _, _), frames in sorted(_scan(kitti_root).items()):
        idx = sorted(frames)
        for frame in idx:
            offset = int(rng.integers(1, max_offset + 1))
            if frame + offset not in frames:
                continue
            a, b = frames[frame], frames[frame + offset]
            cam_a, cam_b = rng.choice(["image_2", "image_3"], size=2)
            pairs.append((a.replace("image_2", cam_a),
                          b.replace("image_2", cam_b)))
    return pairs


# The 20 evaluation sequences of the reference's KITTI_general val/test
# lists — every pair in the frozen lists (reference data_paths/
# KITTI_general_{val,test}.txt) draws both frames from one of these
# `testing`-split sequences.
REFERENCE_GENERAL_EVAL_SEQS: Dict[str, Tuple[str, ...]] = {
    "data_scene_flow_multiview": (
        "000029", "000079", "000085", "000100", "000105",
        "000110", "000129", "000150", "000158", "000175"),
    "data_stereo_flow_multiview": (
        "000004", "000033", "000041", "000044", "000049",
        "000052", "000122", "000158", "000166", "000167"),
}
GENERAL_MAX_OFFSET = 3
GENERAL_VAL_FRAC = 0.2
GENERAL_HOLDOUT_GAP = 41


def general_pair_universe(kitti_root: str,
                          split: str,
                          seqs: Optional[Dict[str, Tuple[str, ...]]] = None,
                          max_offset: int = GENERAL_MAX_OFFSET
                          ) -> List[Tuple[str, str]]:
    """Every ordered same-sequence pair at temporal offset ±1..max_offset,
    in both camera orientations, in canonical enumeration order (subset
    alphabetical, sequence ascending, x-frame ascending, offset -3..+3,
    orientation (x=image_2) before (x=image_3)).

    This is the pair universe underlying the reference's KITTI_general
    val/test lists: their union covers 4519 of exactly these 4560 pairs
    for the 20 eval sequences, and nothing outside it. `seqs` restricts to
    {subset: (seq, ...)}; None takes every sequence found under `split`.
    Both frames must exist in both cameras.
    """
    universe: List[Tuple[str, str]] = []
    scan = _scan(kitti_root)
    for (subset, sp, seq), frames in sorted(scan.items()):
        if sp != split:
            continue
        if seqs is not None and seq not in seqs.get(subset, ()):
            continue
        for fx in sorted(frames):
            for off in range(-max_offset, max_offset + 1):
                if off == 0 or fx + off not in frames:
                    continue
                a, b = frames[fx], frames[fx + off]
                universe.append((a, b.replace("image_2", "image_3")))
                universe.append((a.replace("image_2", "image_3"), b))
    return universe


def reference_general_splits(kitti_root: str, seed: int = 0
                             ) -> Dict[str, List[Tuple[str, str]]]:
    """The reference's KITTI_general split rule, derived from its frozen
    lists (reference data_paths/KITTI_general_{val,test}.txt, 912/3607
    pairs; KITTI_general_train.txt is stripped upstream):

      * eval pair universe = the 20 fixed `testing`-split sequences
        (REFERENCE_GENERAL_EVAL_SEQS) x ordered frame pairs at temporal
        offset ±1..3 (within the 21 frames) x both camera orientations
        = 4560 ordered pairs; verified: frozen val ∪ test is 4519 of
        exactly these pairs, and the two lists are disjoint;
      * the universe is shuffled; val = the first 20% (912 — the frozen
        val size is int(0.2 * 4560) exactly), the next 41 pairs are
        discarded (the frozen test list covers all but 41 of the
        remainder, and those 41 are uniformly spread — a small dropped
        slice, not any file- or structure-dependent filter), test = the
        remaining 3607;
      * train = the same universe construction over every
        `training`-split sequence of both subsets, shuffled.

    Reproducing the frozen lists themselves is impossible in principle:
    both the line order AND the val/test membership partition are one raw
    RNG draw that no structural rule pins down, and searches over seeded
    MT19937 / PCG64 / python-random shuffle and sampling procedures found
    no generating seed — consistent with an unseeded shuffle at creation
    time. This function's seeded shuffle therefore yields a *different*
    (equally valid) membership draw; users wanting the reference's exact
    eval sample should load the frozen files directly. Everything
    derivable — universe, sizes, split fractions, disjointness — is
    reproduced and pinned by tests (the JAX tool's in
    tests/test_make_manifests.py; this copy is held byte-equal to it in
    tests/test_torch_make_manifests.py).
    """
    rng = np.random.default_rng(seed)
    universe = general_pair_universe(kitti_root, "testing",
                                     REFERENCE_GENERAL_EVAL_SEQS)
    order = rng.permutation(len(universe))
    n_val = int(len(universe) * GENERAL_VAL_FRAC)
    gap = GENERAL_HOLDOUT_GAP if len(universe) > GENERAL_HOLDOUT_GAP else 0
    val = [universe[i] for i in order[:n_val]]
    test = [universe[i] for i in order[n_val + gap:]]
    train_univ = general_pair_universe(kitti_root, "training")
    train = [train_univ[i] for i in rng.permutation(len(train_univ))]
    return {"train": train, "val": val, "test": test}


def reference_stereo_splits(kitti_root: str) -> Dict[str, List[Tuple[str, str]]]:
    """The reference's EXACT split rule, reverse-engineered from its frozen
    lists (reference data_paths/KITTI_stereo_{train,val,test}.txt,
    1576/790/790 pairs):

      * only frames 10 and 11 of each sequence are used (the canonical
        KITTI stereo-benchmark frames; the other multiview frames 0..20
        are ignored);
      * train = the `training` split of both subsets, frames 10 AND 11;
      * val   = the `testing` split, frame 11 only;
      * test  = the `testing` split, frame 10 only;
      * every pair appears in BOTH directions — each subset contributes a
        block of forward pairs (x=image_2, y=image_3) followed by the same
        block swapped (x=image_3, y=image_2), doubling the data;
      * ordering: subset alphabetical (data_scene_flow_multiview first),
        then within a subset: forward block then swapped block, each in
        sequence-then-frame ascending order.

    On a standard KITTI multiview layout (scene_flow: 200 train + 200 test
    sequences; stereo_flow: 194 train + 195 test) this reproduces the
    reference's counts (1576/790/790) and line order exactly.
    """
    splits: Dict[str, List[Tuple[str, str]]] = {
        "train": [], "val": [], "test": []}
    by_subset: Dict[str, Dict[str, List[Tuple[str, str]]]] = {}
    for (subset, split, _), frames in sorted(_scan(kitti_root).items()):
        for frame in sorted(frames):
            if frame not in (10, 11):
                continue
            rel2 = frames[frame]
            pair = (rel2, rel2.replace("image_2", "image_3"))
            name = ("train" if split == "training"
                    else "val" if frame == 11 else "test")
            by_subset.setdefault(subset, {"train": [], "val": [],
                                          "test": []})[name].append(pair)
    for subset in sorted(by_subset):
        for name, fwd in by_subset[subset].items():
            splits[name].extend(fwd)
            splits[name].extend((y, x) for x, y in fwd)
    return splits


def cityscapes_stereo_splits(root: str) -> Dict[str, List[Tuple[str, str]]]:
    """Left/right frame pairs in Cityscapes' own train/val/test partition.

    Expected tree (the standard leftImg8bit/rightImg8bit zips):
        <root>/leftImg8bit/<split>/<city>/<stem>_leftImg8bit.png
        <root>/rightImg8bit/<split>/<city>/<stem>_rightImg8bit.png

    Pairs are (left, right) paths relative to <root> — left is the encoder
    input x, right the decoder-only side information y, the same camera
    convention as the KITTI image_2/image_3 pairing above. Cityscapes
    publishes its own city-disjoint split directories, so unlike KITTI no
    split rule is applied here; frames whose right image is missing are
    skipped. Ordering is lexicographic (deterministic across hosts)."""
    splits: Dict[str, List[Tuple[str, str]]] = {}
    for split in ("train", "val", "test"):
        pairs: List[Tuple[str, str]] = []
        left_root = os.path.join(root, "leftImg8bit", split)
        for dirpath, _dirnames, files in sorted(os.walk(left_root)):
            for fname in sorted(files):
                if "_leftImg8bit." not in fname:
                    continue
                left_rel = os.path.relpath(os.path.join(dirpath, fname), root)
                # swap both occurrences (split dir + file suffix) on the
                # root-relative path so a "leftImg8bit" substring in the
                # root path itself stays untouched
                right_rel = left_rel.replace("leftImg8bit", "rightImg8bit")
                if not os.path.isfile(os.path.join(root, right_rel)):
                    continue
                pairs.append((left_rel, right_rel))
        splits[split] = pairs
    return splits


def split_pairs(pairs: List[Tuple[str, str]], val_frac: float,
                test_frac: float, seed: int = 0):
    """Deterministic shuffled split into train/val/test."""
    order = np.random.default_rng(seed).permutation(len(pairs))
    n_val = int(len(pairs) * val_frac)
    n_test = int(len(pairs) * test_frac)
    val = [pairs[i] for i in order[:n_val]]
    test = [pairs[i] for i in order[n_val:n_val + n_test]]
    train = [pairs[i] for i in order[n_val + n_test:]]
    return {"train": train, "val": val, "test": test}


def write_manifest(path: str, pairs: List[Tuple[str, str]]) -> None:
    """Alternating x/y lines (reference DataProvider.py:119-126)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for x, y in pairs:
            f.write(x + "\n" + y + "\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="pair-manifest generator (KITTI, Cityscapes)")
    p.add_argument("--kitti_root", required=True,
                   help="dataset root (name kept for compatibility; for "
                        "--dataset cityscapes pass the Cityscapes root "
                        "holding leftImg8bit/ and rightImg8bit/)")
    p.add_argument("--dataset", choices=("kitti", "cityscapes"),
                   default="kitti",
                   help="cityscapes uses the dataset's own city-disjoint "
                        "train/val/test directories (stereo only; no "
                        "split rule applies) and writes the manifests "
                        "configs/ae_cityscapes_stereo points at")
    p.add_argument("--out_dir", default="data_paths")
    p.add_argument("--mode", choices=("stereo", "general"), default="stereo")
    p.add_argument("--split_rule", choices=("reference", "random"),
                   default="reference",
                   help="'reference' reproduces the reference's frozen "
                        "lists: stereo mode line-for-line (1576/790/790); "
                        "general mode by derived rule (912/3607 eval pairs "
                        "over the same universe, but a different seeded "
                        "membership draw — the reference's unseeded "
                        "shuffle is unrecoverable; load the frozen files "
                        "for its exact eval sample). 'random' is a seeded "
                        "fractional split over all frames")
    p.add_argument("--val_frac", type=float, default=None,
                   help="random rule only (default 0.2); the reference "
                        "rule's splits are fixed by derivation")
    p.add_argument("--test_frac", type=float, default=None,
                   help="random rule only (default 0.2)")
    p.add_argument("--max_offset", type=int, default=None,
                   help="random general rule only (default 2); the "
                        "reference general rule is fixed at ±3")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.dataset == "cityscapes":
        if args.mode != "stereo":
            raise SystemExit("--dataset cityscapes supports only "
                             "--mode stereo (no general-pairing rule "
                             "exists for it)")
        bad = [name for name, v in (("--val_frac", args.val_frac),
                                    ("--test_frac", args.test_frac),
                                    ("--max_offset", args.max_offset))
               if v is not None]
        if bad:
            raise SystemExit(
                f"{', '.join(bad)} cannot be combined with --dataset "
                "cityscapes: it ships its own train/val/test directories")
        splits = cityscapes_stereo_splits(args.kitti_root)
        if not any(splits.values()):
            raise SystemExit("no leftImg8bit/rightImg8bit pairs under "
                             f"{args.kitti_root}")
        for split, split_list in splits.items():
            out = os.path.join(args.out_dir, f"cityscapes_stereo_{split}.txt")
            write_manifest(out, split_list)
            print(f"{out}: {len(split_list)} pairs")
        return

    if args.split_rule == "reference":
        ignored = [name for name, v in (("--val_frac", args.val_frac),
                                        ("--test_frac", args.test_frac),
                                        ("--max_offset", args.max_offset))
                   if v is not None]
        if ignored:
            raise SystemExit(
                f"{', '.join(ignored)} cannot be combined with "
                "--split_rule reference (its splits are fixed by the "
                "derived rule); use --split_rule random")
        splits = (reference_stereo_splits(args.kitti_root)
                  if args.mode == "stereo"
                  else reference_general_splits(args.kitti_root, args.seed))
    else:
        max_offset = 2 if args.max_offset is None else args.max_offset
        pairs = (stereo_pairs(args.kitti_root) if args.mode == "stereo"
                 else general_pairs(args.kitti_root, max_offset, args.seed))
        splits = split_pairs(
            pairs, 0.2 if args.val_frac is None else args.val_frac,
            0.2 if args.test_frac is None else args.test_frac, args.seed)
    if not any(splits.values()):
        raise SystemExit(f"no image_2/image_3 pairs under {args.kitti_root}")
    for split, split_list in splits.items():
        out = os.path.join(args.out_dir,
                           f"KITTI_{args.mode}_{split}.txt")
        write_manifest(out, split_list)
        print(f"{out}: {len(split_list)} pairs")


if __name__ == "__main__":
    main()
