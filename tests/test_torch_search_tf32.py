"""The patch-search kernel's 3xTF32 arithmetic (K1/K2), in plain torch on the
CPU, against the JAX package.

The CUDA kernel (`csrc/sifinder_argmax.cu`) splits every float32 operand x
into hi = tf32(x) and lo = tf32(x - hi), with tf32 = `cvt.rna.tf32.f32`
(round to nearest, ties away from zero, 10 fraction bits), and sums
lo_a*hi_b + hi_a*lo_b + hi_a*hi_b for every product on the tensor cores.
Here:

* `split_tf32` / `round_tf32` of `ops/sifinder_kernel.py` against the
  definition of `cvt.rna` (for normal floats; the operands are never
  subnormal), and the split of bfloat16-rounded operands (lo = 0);
* a plain emulation of the kernel's scores (the three products summed in
  float64 and rounded once to float32, then the kernel's epilogue in its
  multiply order) against the JAX package's Pallas kernels
  `fused_pearson_argmax` and `fused_pearson_argmax_shared` in interpret
  mode, on identical numpy operands, at the tiny geometry (24x36, 8x12
  patches: P 9, K 288, a 17x25 map).

Bounds: indices equal wherever the emulation's top-two margin exceeds 1e-4
(asserted on the data, then required exactly); planted exact copies found
exactly; of two exact copies the lower flat index wins. Scores within 1e-5
of the float32 plain version (`pearson_argmax_reference`) and of the Pallas
kernel: dropping lo_a*lo_b and rounding lo to TF32 move each product by at
most 3 * 2^-22 of |a * b|, and |score| <= 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dsin_tpu.ops import sifinder as jsf
from dsin_tpu.ops import sifinder_pallas as jsp
from dsin_tpu_torch.ops import color as color_lib
from dsin_tpu_torch.ops import sifinder as sf
from dsin_tpu_torch.ops import sifinder_kernel as sk
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, PH, PW = 24, 36, 8, 12
P = (H // PH) * (W // PW)
HC, WC = H - PH + 1, W - PW + 1
MARGIN = 1e-4
SCORE_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _cvt_rna(x: np.ndarray) -> np.ndarray:
    """The definition: |x| rounded to a multiple of its TF32 ulp (2^(e-11)
    for |x| in [2^(e-1), 2^e)), halves away from zero, sign kept."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(x64)
    ulp = np.ldexp(1.0, e - 11)
    return (np.sign(x64) * np.floor(np.abs(x64) / ulp + 0.5) * ulp).astype(
        np.float32)


def test_split_tf32_is_cvt_rna():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000)
         * np.exp(rng.uniform(-30, 30, 20000))).astype(np.float32)
    # exact halves: the 13 dropped bits are 1 0000 0000 0000
    bits = rng.integers(0x00800000, 0x7F000000, 2000).astype(np.uint32)
    ties = ((bits & np.uint32(0xFFFFE000)) | np.uint32(0x1000)).view(
        np.float32)
    x = np.concatenate([x, ties, -ties, [0.0, -0.0, 1.0, -2.5]]).astype(
        np.float32)
    t = torch.from_numpy(x)
    hi, lo = sk.split_tf32(t)
    np.testing.assert_array_equal(hi.numpy(), _cvt_rna(x))
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal(hi + lo, t)                  # lo is exact in float32
    assert torch.equal(sk.round_tf32(t), hi)
    # halves round away from zero: up in magnitude
    th = sk.round_tf32(torch.from_numpy(ties.copy()))
    assert bool((th.abs() > torch.from_numpy(ties).abs()).all())
    assert torch.equal(sk.round_tf32(-torch.from_numpy(ties.copy())), -th)


def test_bfloat16_operands_split_with_lo_zero():
    """`sifinder_dtype = 'bfloat16'` rounds the operands to bfloat16: they
    are exact in TF32, so the kernel's lo parts are 0 and its products
    exact."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-300, 300, 5000).astype(np.float32))
    hi, lo = sk.split_tf32(sf.round_operand(x, torch.bfloat16))
    assert bool((lo == 0).all())
    assert torch.equal(hi, sf.round_operand(x, torch.bfloat16))


def emulated_3xtf32(y_t, pk, inv, gh, gw_t, ph, pw):
    """The kernel's arithmetic in plain torch: (best_val, best_idx, score map
    (B, P, Hc * Wc)). num = hi_a*hi_b + hi_a*lo_b + lo_a*hi_b with
    lo = tf32(x - hi), summed in float64 and rounded once to float32; the
    epilogue ((num * inv_denom) * gh) * gw in float32; the first maximum."""
    b, c, h, w = y_t.shape
    p = pk.shape[1]
    hc, wc = h - ph + 1, w - pw + 1

    def parts(v):
        hi, lo = sk.split_tf32(v.contiguous())
        return hi.double(), sk.round_tf32(lo).double()

    # (dc, ch, dr) -> unfold's (ch, dr, dc) k-order
    a_hi, a_lo = (v.reshape(b, p, pw, c, ph).permute(0, 1, 3, 4, 2)
                  .reshape(b, p, -1) for v in parts(pk))
    y_hi, y_lo = (F.unfold(v, (ph, pw)) for v in parts(y_t))
    num = (a_hi @ y_hi + a_hi @ y_lo + a_lo @ y_hi).float()
    score = num * inv.reshape(b, 1, -1)
    score = score * gh.t()[None, :, :, None].expand(b, p, hc, wc).reshape(
        b, p, -1)
    score = score * gw_t[None, :, None, :].expand(b, p, hc, wc).reshape(
        b, p, -1)
    idx = torch.argmax(score, dim=2)
    val = torch.gather(score, 2, idx[..., None])[..., 0]
    return val, idx.to(torch.int32), score


def _margin(score):
    top = torch.topk(score, 2, dim=2).values
    return top[..., 0] - top[..., 1]


def _rand_pair(seed, batch=2, h=H, w=W):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (batch, h, w, 3)).astype(np.float32)
    y = np.clip(x[:, ::-1] * 0.6 + rng.uniform(0, 255, x.shape) * 0.4,
                0, 255).astype(np.float32)
    return x, y


def _pallas_operands(x, y, prior):
    preps = [jsp._prepare_single(jnp.asarray(a), jnp.asarray(b), PH, PW,
                                 1e-12) for a, b in zip(x, y)]
    y_t, pk, inv = (np.stack([np.asarray(p[i]) for p in preps])
                    for i in range(3))
    if prior:
        gh, gw = jsf.gaussian_position_mask_factors(H, W, PH, PW)
    else:
        gh, gw = (np.ones((HC, P), np.float32), np.ones((WC, P), np.float32))
    return y_t, pk, inv, gh, np.ascontiguousarray(gw.T)


def _hold(ops, val, idx, score, jval, jidx, spots=()):
    """The emulation against the Pallas kernel's (jval, jidx) and against
    the float32 plain version."""
    jval, jidx = _t(jval), _t(jidx).to(torch.int32)
    clear = _margin(score) > MARGIN
    assert bool(clear.any())
    assert torch.equal(idx[clear], jidx[clear])
    assert not bool(sk.index_disagreements(ops, PH, PW, idx, jval, jidx,
                                           MARGIN).any())
    rval, _ = sk.pearson_argmax_reference(*ops, PH, PW)
    assert float((val - rval).abs().max()) <= SCORE_ATOL
    assert float((val - jval).abs().max()) <= SCORE_ATOL
    for b, p, flat in spots:
        assert int(idx[b, p]) == int(jidx[b, p]) == flat


@pytest.mark.parametrize("planted", [False, True])
def test_emulation_matches_pallas_kernel(planted):
    """K1: the 3xTF32 emulation against `fused_pearson_argmax`
    (interpret); planted copies (no prior) found exactly."""
    x, y = _rand_pair(5)
    spots = []
    if planted:
        for b, (patch_idx, r0, c0) in enumerate([(4, 5, 9), (7, 0, 20)]):
            pr, pc = (patch_idx // (W // PW)) * PH, (patch_idx % (W // PW)) * PW
            y[b, r0:r0 + PH, c0:c0 + PW] = x[b, pr:pr + PH, pc:pc + PW]
            spots.append((b, patch_idx, r0 * WC + c0))
    ops = _pallas_operands(x, y, prior=not planted)
    jval, jidx = jsp.fused_pearson_argmax(*map(jnp.asarray, ops), ph=PH,
                                          pw=PW, interpret=True)
    tops = tuple(map(_t, ops))
    val, idx, score = emulated_3xtf32(*tops, PH, PW)
    _hold(tops, val, idx, score, jval, jidx, spots)


def test_emulation_matches_pallas_shared_kernel():
    """K2: the emulation on one side image shared by 3 queries against
    `fused_pearson_argmax_shared` (interpret) on a JAX prep padded for
    it."""
    x, y = _rand_pair(6, batch=3)
    factors = jsf.gaussian_position_mask_factors(H, W, PH, PW)
    jprep = jsf.build_side_prep(jnp.asarray(y[0]), jnp.asarray(y[0]), PH, PW,
                                mask_factors=factors, for_pallas=True)
    pk = np.stack([np.asarray(jsp._prepare_query(jnp.asarray(a), PH, PW,
                                                 1e-12)) for a in x])
    jval, jidx = jsp.fused_pearson_argmax_shared(
        jprep.y_t_pad, jnp.asarray(pk), jprep.inv_denom_pad, jprep.gh_pad,
        jprep.gw_t_pad, ph=PH, pw=PW, hc=HC, wc=WC, interpret=True)
    y_t, inv = jsp._prepare_side(jnp.asarray(y[0]), PH, PW, 1e-12)
    ops = (_t(y_t)[None].expand(3, -1, -1, -1), _t(pk),
           _t(inv)[None].expand(3, -1, -1), _t(factors[0]),
           _t(np.ascontiguousarray(factors[1].T)))
    val, idx, score = emulated_3xtf32(*ops, PH, PW)
    _hold(ops, val, idx, score, jval, jidx)


def test_emulated_tie_goes_to_the_lowest_flat_index():
    """Two exact copies of one x patch score bit-equal under the 3xTF32
    arithmetic (the same products in the same order), so the lower flat
    index wins, as with jnp.argmax."""
    h2, w2 = 16, 288
    wc2 = w2 - PW + 1
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 255, (1, h2, w2, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (1, h2, w2, 3)).astype(np.float32)
    patch_idx = 2
    pr, pc = (patch_idx // (w2 // PW)) * PH, (patch_idx % (w2 // PW)) * PW
    flat_a, flat_b = 200, wc2
    for flat in (flat_a, flat_b):
        r0, c0 = divmod(flat, wc2)
        y[0, r0:r0 + PH, c0:c0 + PW] = x[0, pr:pr + PH, pc:pc + PW]
    pk = sk.prepare_query(_t(x), PH, PW)
    y_t, inv = sk.side_from_transformed(
        color_lib.search_transform(_t(y[0])), PH, PW)
    p2 = pk.shape[1]
    _, idx, score = emulated_3xtf32(
        y_t[None], pk, inv[None], torch.ones(h2 - PH + 1, p2),
        torch.ones(p2, wc2), PH, PW)
    assert score[0, patch_idx, flat_a] == score[0, patch_idx, flat_b]
    assert int(idx[0, patch_idx]) == flat_a
