"""The CUDA patch-search kernel against its plain torch version, on the card.

Every test here needs an NVIDIA card and nvcc; on a machine without a card
they skip (decided inside the `cuda` fixture, so every pytest-xdist worker
collects the same tests). This file imports no jax, so it also runs where
jax is absent:

    python -m pytest --noconftest -q tests/test_torch_kernel_gpu.py

Tolerances: the kernel and the plain version sum the same fp32 products in
another order, so best values agree to rtol 1e-4 (atol 1e-5) and indices
agree wherever the plain version's top-two margin exceeds 1e-4
(`index_disagreements`). Planted exact copies and ties are compared exactly.
"""

import numpy as np
import pytest
import torch

from dsin_tpu_torch.ops import color as color_lib
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.ops import sifinder_kernel as sk

ATOL_MARGIN = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(x, y, ph, pw, prior, dev):
    """Batched kernel operands from NHWC numpy images."""
    xt = torch.from_numpy(x).to(dev)
    pk = sk.prepare_query(xt, ph, pw)
    sides = [sk.side_from_transformed(
        color_lib.search_transform(torch.from_numpy(yi).to(dev)), ph, pw)
        for yi in y]
    y_t = torch.stack([s[0] for s in sides])
    inv = torch.stack([s[1] for s in sides])
    h, w = x.shape[1:3]
    if prior:
        gh, gw = sifinder_lib.gaussian_position_mask_factors(h, w, ph, pw)
    else:
        p = (h // ph) * (w // pw)
        gh = np.ones((h - ph + 1, p), np.float32)
        gw = np.ones((w - pw + 1, p), np.float32)
    return (y_t, pk, inv, torch.from_numpy(gh).to(dev),
            torch.from_numpy(np.ascontiguousarray(gw.T)).to(dev))


def _assert_agree(ops, ph, pw, got, ref):
    val, idx = got
    rval, ridx = ref
    torch.testing.assert_close(val, rval, rtol=1e-4, atol=1e-5)
    bad = sk.index_disagreements(ops, ph, pw, idx, rval, ridx, ATOL_MARGIN)
    assert int(bad.sum()) == 0, f"{int(bad.sum())} index disagreements"


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,ph,pw,prior", [
    (24, 36, 8, 12, True),        # 17x25 map: one ragged position tile
    (40, 48, 20, 24, True),       # the tiny test configuration
    (40, 288, 20, 24, False),     # 21x265: several tiles, one group
    (100, 1224, 20, 24, True),    # 81x1201: many groups, P = 255
])
def test_kernel_matches_plain(cuda, h, w, ph, pw, prior):
    rng = np.random.default_rng(h * w)
    x = rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)
    ops = _operands(x, y, ph, pw, prior, cuda)
    got = sk.pearson_argmax(*ops, ph, pw)
    ref = sk.pearson_argmax_reference(*ops, ph, pw)
    torch.cuda.synchronize()
    _assert_agree(ops, ph, pw, got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,ph,pw,prior", [
    (30, 56, 5, 7, False),        # K = 105: K % 8 != 0, 4-byte pk copies;
    #                               Wc = 50 < one 64-column tile; P = 48
    (40, 192, 20, 24, True),      # Hc = 21: the last 2-row tile half empty;
    #                               P = 16 < one 64-patch tile
    (64, 160, 4, 5, False),       # K = 60: a k tail of 28 in the last slice
    (300, 48, 150, 1, False),     # 150-row patches: no slab fits, B read
    #                               from global memory
], ids=["5x7", "odd-rows", "k-tail", "tall-patch"])
def test_awkward_tiling_matches_plain(cuda, h, w, ph, pw, prior):
    """Shapes that the row-aligned tiles and the k slices meet only at
    their edges."""
    rng = np.random.default_rng(h * w + ph)
    x = rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)
    ops = _operands(x, y, ph, pw, prior, cuda)
    got = sk.pearson_argmax(*ops, ph, pw)
    ref = sk.pearson_argmax_reference(*ops, ph, pw)
    torch.cuda.synchronize()
    _assert_agree(ops, ph, pw, got, ref)


@pytest.mark.gpu
def test_cityscapes_patches_match_plain(cuda):
    """The Cityscapes geometry's queries (1024x2048, 16x32 patches: P =
    4096, K = 1536) against a side image cut to 64 rows (a 49x2017 map), so
    the plain version stays quick."""
    rng = np.random.default_rng(9)
    ph, pw, side_h = 16, 32, 64
    x = rng.uniform(0, 255, (1, 1024, 2048, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (1, side_h, 2048, 3)).astype(np.float32)
    pk = sk.prepare_query(torch.from_numpy(x).to(cuda), ph, pw)
    y_t, inv = sk.side_from_transformed(color_lib.search_transform(
        torch.from_numpy(y[0]).to(cuda)), ph, pw)
    gh, gw = sifinder_lib.gaussian_position_mask_factors(1024, 2048, ph, pw)
    ops = (y_t[None].contiguous(), pk, inv[None].contiguous(),
           torch.from_numpy(gh[:side_h - ph + 1]).to(cuda),
           torch.from_numpy(np.ascontiguousarray(gw.T)).to(cuda))
    assert pk.shape == (1, 4096, 1536)
    got = sk.pearson_argmax(*ops, ph, pw)
    ref = sk.pearson_argmax_reference(*ops, ph, pw)
    torch.cuda.synchronize()
    _assert_agree(ops, ph, pw, got, ref)


@pytest.mark.gpu
def test_kernel_matches_plain_full_size(cuda):
    """320x1224, 20x24 patches: P = 816 (ragged patch tile), 301x1201 map."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (1, 320, 1224, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (1, 320, 1224, 3)).astype(np.float32)
    ops = _operands(x, y, 20, 24, True, cuda)
    got = sk.pearson_argmax(*ops, 20, 24)
    ref = sk.pearson_argmax_reference(*ops, 20, 24)
    torch.cuda.synchronize()
    _assert_agree(ops, 20, 24, got, ref)


@pytest.mark.gpu
def test_shared_is_bit_identical_to_per_image(cuda):
    rng = np.random.default_rng(5)
    h, w, ph, pw = 40, 288, 20, 24
    x = rng.uniform(0, 255, (3, h, w, 3)).astype(np.float32)
    y = np.repeat(rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32), 3, 0)
    y_t, pk, inv, gh, gw_t = _operands(x, y, ph, pw, True, cuda)
    per = sk.pearson_argmax(y_t, pk, inv, gh, gw_t, ph, pw)
    shared = sk.pearson_argmax_shared(y_t[0].contiguous(), pk,
                                      inv[0].contiguous(), gh, gw_t, ph, pw)
    assert torch.equal(per[0], shared[0]) and torch.equal(per[1], shared[1])


@pytest.mark.gpu
def test_ties_across_blocks_take_lowest_flat_index(cuda):
    """Two exact copies of one x patch, in different position groups (so in
    different blocks): stage 2 must keep the lower flat index."""
    h, w, ph, pw = 100, 1224, 20, 24
    wc = w - pw + 1
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
    patch_idx = 3
    pr, pc = (patch_idx // (w // pw)) * ph, (patch_idx % (w // pw)) * pw
    flats = (5 * wc + 7, 60 * wc + 900)    # far apart in flat order
    for flat in flats:
        r0, c0 = divmod(flat, wc)
        y[0, r0:r0 + ph, c0:c0 + pw] = x[0, pr:pr + ph, pc:pc + pw]
    ops = _operands(x, y, ph, pw, False, cuda)
    _, idx = sk.pearson_argmax(*ops, ph, pw)
    _, ridx = sk.pearson_argmax_reference(*ops, ph, pw)
    assert int(idx[0, patch_idx]) == int(ridx[0, patch_idx]) == flats[0]


@pytest.mark.gpu
def test_launch_counter_counts_kernel_launches_only(cuda):
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 255, (1, 40, 48, 3)).astype(np.float32)
    ops = _operands(x, x, 20, 24, True, cuda)
    sk.reset_launch_counts()
    sk.pearson_argmax_reference(*ops, 20, 24)
    assert sk.launch_counts == {"pearson_argmax": 0,
                                "pearson_argmax_shared": 0}
    sk.pearson_argmax(*ops, 20, 24)
    sk.pearson_argmax_shared(ops[0][0].contiguous(), ops[1],
                             ops[2][0].contiguous(), ops[3], ops[4], 20, 24)
    assert sk.launch_counts == {"pearson_argmax": 1,
                                "pearson_argmax_shared": 1}


@pytest.mark.gpu
def test_wrapper_refuses_bf16(cuda):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 255, (1, 40, 48, 3)).astype(np.float32)
    y_t, pk, inv, gh, gw_t = _operands(x, x, 20, 24, True, cuda)
    with pytest.raises(TypeError, match="float32"):
        sk.pearson_argmax(y_t.bfloat16(), pk, inv, gh, gw_t, 20, 24)


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [False, True], ids=["K1", "K2"])
def test_bf16_rounded_operands_match_plain(cuda, shared):
    """`sifinder_dtype = 'bfloat16'`: `pk` and `y_t` rounded to bfloat16 and
    held as float32 run the unchanged float32 kernel; it agrees with the
    plain version on the same rounded operands under the margin rule."""
    rng = np.random.default_rng(17)
    h, w, ph, pw = 100, 1224, 20, 24
    x = rng.uniform(0, 255, (3, h, w, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (1 if shared else 3, h, w, 3)).astype(np.float32)
    if shared:
        y = np.repeat(y, 3, 0)
    y_t, pk, inv, gh, gw_t = _operands(x, y, ph, pw, True, cuda)
    y_t = sifinder_lib.round_operand(y_t, torch.bfloat16)
    pk = sifinder_lib.round_operand(pk, torch.bfloat16)
    ops = (y_t, pk, inv, gh, gw_t)
    if shared:
        got = sk.pearson_argmax_shared(y_t[0].contiguous(), pk,
                                       inv[0].contiguous(), gh, gw_t, ph, pw)
    else:
        got = sk.pearson_argmax(*ops, ph, pw)
    ref = sk.pearson_argmax_reference(*ops, ph, pw)
    torch.cuda.synchronize()
    _assert_agree(ops, ph, pw, got, ref)


@pytest.mark.gpu
def test_the_knob_reaches_the_kernel_route(cuda):
    """The kernel route under 'bfloat16' on the card against the torch
    route on the CPU under the same knob (y_syn equal wherever the plain
    top-two margin is clear), and a float32 prep refused by a bfloat16
    search."""
    from dsin_tpu_torch.config import Config
    rng = np.random.default_rng(3)
    h, w, ph, pw = 40, 48, 8, 12
    x = rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)
    y = np.clip(x[:, ::-1] * 0.6 + rng.uniform(0, 255, x.shape) * 0.4,
                0, 255).astype(np.float32)
    x_hat = (x + rng.normal(0, 4, x.shape)).astype(np.float32)

    def cfg(impl):
        return Config({"use_L2andLAB": False, "sifinder_impl": impl,
                       "sifinder_dtype": "bfloat16"})

    args = [torch.from_numpy(a) for a in (x_hat, y, y)]
    sk.reset_launch_counts()
    got = sifinder_lib.synthesize_side_image(
        *[a.to(cuda) for a in args], None, ph, pw, cfg("kernel"))
    assert sk.launch_counts["pearson_argmax"] == 1
    want = sifinder_lib.synthesize_side_image(*args, None, ph, pw,
                                              cfg("torch"))
    for i in range(2):
        res = sifinder_lib.search_single(*[a[i] for a in args], None, ph, pw,
                                         conv_dtype=torch.bfloat16)
        flat = torch.sort(res.score_map.reshape(-1, res.score_map.shape[-1]),
                          0).values
        clear = (flat[-1] - flat[-2] > ATOL_MARGIN).reshape(h // ph, w // pw)
        diff = (got[i].cpu() - want[i]).abs().reshape(
            h // ph, ph, w // pw, pw, 3).amax(dim=(1, 3, 4))
        assert bool((diff[clear] == 0).all())
    prep = sifinder_lib.build_side_prep(
        args[1][0].to(cuda), args[2][0].to(cuda), ph, pw, for_kernel=True)
    with pytest.raises(sifinder_lib.PrepDtypeMismatch):
        sifinder_lib.synthesize_side_image_prepped(
            args[0].to(cuda), prep, ph, pw, cfg("kernel"))
