"""K3's pruning and its prepared buffer on the CPU: the positions the logit
needs (`needed_positions`), the compacted weights and tables the kernel walks
(`prepare_front`), held against the port's plain version and the JAX
package's Pallas kernel in interpret mode.

Tolerances: replacing inputs the logit does not need changes no output bit
(`torch.equal` / `np.array_equal`), for the plain version and for the Pallas
kernel alike, because the masked taps carry exact zeros; the compacted
buffer expands back to the weight matrices exactly; a float32 walk of the
buffer's tables (the kernel's walk, in numpy) agrees with the plain version
within rtol/atol 1e-5, the slack tests/test_probclass_pallas.py:49 allows
between two orders of the same fp32 sums, and is bit-equal to itself with
NaN in every unneeded input.
"""

import numpy as np
import pytest
import torch

from dsin_tpu.coding import probclass_pallas as jax_pallas
from dsin_tpu_torch.coding import probclass_kernel as pk
from dsin_tpu_torch.models import probclass as pc_lib

L = 6
WIDTHS = {"tiny": 12, "pc_default": 24}


def _weights(c: int, seed: int = 0):
    """Pre-masked (taps*Cin, Cout) float32 matrices and (Cout,) biases, in
    the convention of `front_weight_matrices`, from a seeded numpy draw."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (cin, cout) in enumerate([(1, c), (c, c), (c, c), (c, L)]):
        mask = pc_lib.make_mask(3, i > 0).reshape(-1, 1, 1)
        w = rng.normal(0, (2.0 / (18 * cin + cout)) ** 0.5,
                       (18, cin, cout)) * mask
        out.append((w.reshape(18 * cin, cout).astype(np.float32),
                    rng.normal(0, 0.1, cout).astype(np.float32)))
    return out


def _torch(mats):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in mats]


def _unneeded_mask():
    """(5, 9, 9) bool: the inputs no logit reads."""
    keep = np.zeros(pk.CONTEXT, bool)
    for p in pk.needed_positions(3)[0]:
        keep[p] = True
    return ~keep


def _blocks(batch: int, seed: int):
    centers = np.sort(np.random.default_rng(seed).uniform(-2, 2, L))
    return np.random.default_rng(seed + 1).choice(
        centers, size=(batch,) + pk.CONTEXT).astype(np.float32)


def test_needed_positions_counts():
    need = pk.needed_positions(3)
    assert [len(p) for p in need] == [294, 144, 56, 14]
    slices = [[sum(1 for p in ps if p[0] == d) for d in range(g)]
              for ps, g in zip(need, (5, 4, 3, 2))]
    assert slices == [[81, 71, 60, 48, 34], [49, 41, 32, 22], [25, 19, 12],
                      [9, 5]]
    assert [len(pk.kept_taps(3, c)) for c in (False, True)] == [13, 14]
    assert pk.needed_fmas(24, 6) == 611_424
    assert pk.needed_fmas(12, 6) == (144 * 13 * 12 + 56 * 14 * 12 * 12
                                     + 14 * 14 * 12 * 12 + 14 * 12 * 6)


def test_needed_inputs_are_exactly_those_the_logit_depends_on():
    """With positive weights, biases and inputs every ReLU passes and no sum
    cancels, so the gradient of the logits is nonzero on exactly the inputs
    they depend on: the needed set, no more and no less."""
    mats = [(np.abs(w), np.abs(b) + 0.1) for w, b in _weights(12)]
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0.5, 1.5, (1,) + pk.CONTEXT).astype(np.float32)).requires_grad_()
    pk.probclass_front_logits_reference(x, _torch(mats)).sum().backward()
    np.testing.assert_array_equal(x.grad[0].numpy() != 0, ~_unneeded_mask())


@pytest.mark.parametrize("width", WIDTHS.values(), ids=WIDTHS.keys())
@pytest.mark.parametrize("batch", [1, 5, 130])
def test_unneeded_inputs_leave_plain_and_pallas_bit_equal(width, batch):
    """N(0, 100^2) in every unneeded input: the port's plain version and the
    Pallas kernel (interpret mode; 130 blocks run its two-tile grid) give
    the same bits as on the blocks as drawn."""
    mats = _weights(width, seed=batch)
    blocks = _blocks(batch, seed=batch)
    noisy = blocks.copy()
    drop = np.broadcast_to(_unneeded_mask(), blocks.shape)
    noisy[drop] = np.random.default_rng(7).normal(0, 100, int(drop.sum()))
    weights = _torch(mats)
    want = pk.probclass_front_logits(torch.from_numpy(blocks), weights)
    got = pk.probclass_front_logits(torch.from_numpy(noisy), weights)
    assert torch.equal(got, want)
    flat = [a for w, b in mats for a in (w, b[None])]
    jwant = np.asarray(jax_pallas.probclass_front_logits(
        blocks, *flat, interpret=True))
    jgot = np.asarray(jax_pallas.probclass_front_logits(
        noisy, *flat, interpret=True))
    assert np.array_equal(jgot, jwant)
    np.testing.assert_allclose(want.numpy(), jwant, rtol=1e-5, atol=1e-5)


def _expand(params):
    """The buffer's compacted weights back to full (taps*Cin, Cout) pairs."""
    lay, words = params.layout, params.buffer.numpy()
    c, l_out = lay["channels"], lay["logits"]
    out = []
    for i, (cin, cout) in enumerate([(1, c), (c, c), (c, c), (c, l_out)]):
        rows = np.flatnonzero(pc_lib.make_mask(3, i > 0).ravel())
        kept = words[lay[f"w{i}"]:lay[f"w{i}"] + len(rows) * cin * cout]
        w = np.zeros((18, cin, cout), np.float32)
        w[rows] = kept.reshape(len(rows), cin, cout)
        out.append((w.reshape(18 * cin, cout),
                    words[lay[f"b{i}"]:lay[f"b{i}"] + cout]))
    return out


@pytest.mark.parametrize("width", WIDTHS.values(), ids=WIDTHS.keys())
def test_buffer_expands_back_and_is_aligned(width):
    mats = _weights(width)
    params = pk.prepare_front(_torch(mats))
    for (w, b), (ew, eb) in zip(mats, _expand(params)):
        assert np.array_equal(ew, w) and np.array_equal(eb, b)
    lay = params.layout
    assert tuple(lay) == pk.LAYOUT_FIELDS
    assert params.buffer.dtype == torch.float32
    assert params.buffer.numel() == lay["seg_end2"]
    assert all(v % 4 == 0 for k, v in lay.items()       # 16-byte pieces
               if k[:-1] in ("taps", "pos", "w", "b", "seg_end")
               or k.startswith("smem"))
    # the segments hold, in order: the tables with w0, b0; w1, b1; the rest
    assert lay["taps0"] == 0 < lay["w0"] < lay["b0"] < lay["seg_end0"]
    assert lay["seg_end0"] == lay["w1"] < lay["b1"] < lay["seg_end1"]
    assert lay["seg_end1"] == lay["w2"] < lay["b3"] < lay["seg_end2"]
    assert [lay[f"ntaps{i}"] for i in range(4)] == [13, 14, 14, 14]
    assert [lay[f"npos{i}"] for i in range(4)] == [144, 56, 14, 1]


def test_two_blocks_fit_an_sm_at_pc_default():
    """About 104 KB a block at C = 24: two blocks on one H100 SM (233,472
    bytes, 1 KB reserved a block), so a 248-block front is one wave."""
    lay = pk.prepare_front(_torch(_weights(24))).layout
    smem = 4 * lay["smem_words"] + 24           # + three mbarriers
    assert 100_000 < smem and 2 * (smem + 1024) <= 233_472


def _walk(blocks: np.ndarray, params) -> np.ndarray:
    """The kernel's walk of the buffer in numpy float32: for each layer,
    each table entry's kept taps gathered from the dense grid at its input
    position, times the compacted W, plus b; writes only the table's
    positions (grids start as NaN, so a read of anything else shows)."""
    lay, words = params.layout, params.buffer.numpy()
    ints = words.view(np.int32)
    c, l_out = lay["channels"], lay["logits"]
    sizes = [405, 196, 75, 18, 1]
    grids = [blocks.reshape(len(blocks), 405, 1)]
    for i, (cin, cout) in enumerate([(1, c), (c, c), (c, c), (c, l_out)]):
        taps = ints[lay[f"taps{i}"]:lay[f"taps{i}"] + lay[f"ntaps{i}"]]
        pos = ints[lay[f"pos{i}"]:lay[f"pos{i}"] + 3 * lay[f"npos{i}"]]
        pos = pos.reshape(-1, 3)
        w = words[lay[f"w{i}"]:lay[f"w{i}"] + len(taps) * cin * cout]
        b = words[lay[f"b{i}"]:lay[f"b{i}"] + cout]
        x = grids[i][:, pos[:, 1:2] + taps[None, :], :]    # (B, n, taps, cin)
        y = x.reshape(len(blocks), len(pos), -1) @ w.reshape(-1, cout) + b
        if i == 2:
            y = y + grids[1][:, pos[:, 2], :]
        else:
            y = np.maximum(y, 0)
        out = np.full((len(blocks), sizes[i + 1], cout), np.nan, np.float32)
        out[:, pos[:, 0], :] = y
        grids.append(out)
    return grids[4].reshape(len(blocks), l_out)


@pytest.mark.parametrize("width", WIDTHS.values(), ids=WIDTHS.keys())
def test_table_walk_matches_plain_and_reads_only_needed(width):
    mats = _weights(width, seed=3)
    params = pk.prepare_front(_torch(mats))
    blocks = _blocks(64, seed=3)
    got = _walk(blocks, params)
    want = pk.probclass_front_logits_reference(torch.from_numpy(blocks),
                                               _torch(mats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    nan, zero = blocks.copy(), blocks.copy()
    drop = np.broadcast_to(_unneeded_mask(), blocks.shape)
    nan[drop], zero[drop] = np.nan, 0.0
    walked = _walk(nan, params)
    assert np.isfinite(walked).all()
    assert np.array_equal(walked, _walk(zero, params))


def test_prepared_params_on_the_cpu_take_the_plain_version():
    mats = _weights(12)
    engine = pk.ProbclassFrontKernel(mats, torch.device("cpu"))
    blocks = _blocks(9, seed=4)
    pk.reset_launch_counts()
    got = engine.front_logits(blocks)
    want = pk.probclass_front_logits_reference(torch.from_numpy(blocks),
                                               _torch(mats)).numpy()
    assert pk.launch_counts == {"probclass_front_logits": 0}
    assert np.array_equal(got, want)


def test_engine_on_the_cpu_takes_any_width():
    """C = 6 is off the kernel's float4 tile (the card refuses it), but the
    engine prepares its buffer and the CPU runs the plain version."""
    mats = _weights(6)
    engine = pk.ProbclassFrontKernel(mats, torch.device("cpu"))
    assert engine.params.layout["channels"] == 6
    blocks = _blocks(3, seed=5)
    want = pk.probclass_front_logits_reference(torch.from_numpy(blocks),
                                               _torch(mats)).numpy()
    assert np.array_equal(engine.front_logits(blocks), want)
