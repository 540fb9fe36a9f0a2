"""The fused decode epilogue kernel (K4) against its plain torch version, on
the card.

Every test here needs an NVIDIA card and nvcc; on a machine without a card
they skip (decided inside the `cuda` fixture, so every pytest-xdist worker
collects the same tests). This file imports no jax, so it also runs where
jax is absent:

    python -m pytest --noconftest -q tests/test_torch_epilogue_gpu.py

Tolerances: rtol 1e-5, atol 1e-3 in [0, 255] pixel units for float32 and
bfloat16 operands alike (tests/test_epilogue_pallas.py:32): the kernel and
the plain version sum the same float32 products (bfloat16 operands are
widened first, and their products are exact in float32) in another order,
and the denormalization scales that slack by about 75. Pixels are a function
of their own inputs only: bit-identical whatever the batch.
"""

import numpy as np
import pytest
import torch

from dsin_tpu_torch import native_build
from dsin_tpu_torch.entry import full_configs
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops import epilogue as epi_lib

RTOL, ATOL = 1e-5, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def epi(cuda):
    """The fold of the full-width decoder's seeded conv2 (Cin = 64)."""
    ae, pc = full_configs()
    model = build_model(ae, pc, device=cuda, seed=0)
    return epi_lib.fold_epilogue_params(model.decoder, ae.normalization)


def _x(shape, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.abs(rng.normal(size=shape)).astype(
        np.float32)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 160, 612, 64),      # the main path: 320x1224 images at batch 2
    (1, 5, 9, 64),          # smaller than one 32x24 tile
    (3, 17, 45, 64),        # ragged in both directions
    (1, 8, 32, 64),         # two tiles wide, a quarter of one high
])
def test_kernel_matches_plain(cuda, epi, shape, dtype):
    x = _x(shape, cuda, seed=shape[1]).to(dtype)
    wmat = epi.wmat.to(dtype)
    img, srch = epi_lib.fused_decode_epilogue(x, wmat, *epi[1:])
    ref_img, ref_srch = epi_lib.epilogue_reference(x, wmat, *epi[1:])
    torch.cuda.synchronize()
    n, h2, w2, _ = shape
    assert tuple(img.shape) == (n, 2 * h2, 2 * w2, 3)
    torch.testing.assert_close(img, ref_img, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(srch, ref_srch, rtol=RTOL, atol=ATOL)


def _epi_for(cin, dev, seed):
    """Operands for another Cin: a seeded (25*Cin, 3) deconv matrix, an
    affine that keeps most pixels inside the clip, the identity map."""
    rng = np.random.default_rng(seed)
    return epi_lib.EpilogueParams(
        torch.from_numpy((rng.normal(size=(25 * cin, 3)) / np.sqrt(
            25 * cin)).astype(np.float32)).to(dev),
        torch.full((1, 3), 40.0, device=dev),
        torch.full((1, 3), 120.0, device=dev),
        torch.eye(3, device=dev), torch.zeros((1, 3), device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 33, 612, 64),      # W2 = 25 tiles of 24 + 12; odd H2, one row past
    (3, 17, 37, 64),       # W2 off the 6-wide strip and the 24-wide tile
    (1, 31, 1, 64),        # one column
    (3, 5, 37, 1),         # Cin 1: staged by ordinary loads
    (1, 9, 612, 3),        # Cin 3: not a whole 4-channel group
    (3, 7, 37, 128),       # the widest Cin the kernel takes
    (1, 64, 96, 24),       # Cin a multiple of 4, not of the 8-channel chunk
    (1, 32, 24, 64),       # exactly one tile
])
def test_tile_edges_match_plain(cuda, shape, dtype):
    n, h2, w2, cin = shape
    epi = _epi_for(cin, cuda, seed=cin)
    x = _x(shape, cuda, seed=h2 + w2).to(dtype)
    wmat = epi.wmat.to(dtype)
    img, srch = epi_lib.fused_decode_epilogue(x, wmat, *epi[1:])
    ref_img, ref_srch = epi_lib.epilogue_reference(x, wmat, *epi[1:])
    torch.cuda.synchronize()
    assert tuple(img.shape) == (n, 2 * h2, 2 * w2, 3)
    torch.testing.assert_close(img, ref_img, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(srch, ref_srch, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_input_takes_the_ordinary_loads(cuda, epi, dtype):
    """x that starts off a 4-channel boundary (a contiguous view at an odd
    element offset) cannot be copied by cp.async; the kernel stages it
    with ordinary loads and gives the same bits as an aligned copy."""
    shape = (1, 12, 40, 64)
    flat = _x((1 + int(np.prod(shape)),), cuda, seed=9).to(dtype)
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    wmat = epi.wmat.to(dtype)
    got = epi_lib.fused_decode_epilogue(x, wmat, *epi[1:])
    want = epi_lib.fused_decode_epilogue(x.clone(), wmat, *epi[1:])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_small_cin_and_clip_rails(cuda):
    rng = np.random.default_rng(4)
    cin = 3
    epi = epi_lib.EpilogueParams(
        torch.from_numpy(rng.normal(size=(25 * cin, 3)).astype(
            np.float32)).to(cuda),
        torch.full((1, 3), 75.0, device=cuda),
        torch.full((1, 3), 95.0, device=cuda),
        torch.eye(3, device=cuda), torch.zeros((1, 3), device=cuda))
    x = torch.from_numpy(rng.normal(size=(2, 11, 37, cin)).astype(
        np.float32)).to(cuda)
    img, srch = epi_lib.fused_decode_epilogue(x, *epi)
    ref_img, ref_srch = epi_lib.epilogue_reference(x, *epi)
    torch.testing.assert_close(img, ref_img, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(srch, ref_srch, rtol=RTOL, atol=ATOL)
    assert float(img.min()) == 0.0 and float(img.max()) == 255.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_images_are_bit_identical_across_batches(cuda, epi, dtype):
    x = _x((4, 21, 70, 64), cuda, seed=5).to(dtype)
    wmat = epi.wmat.to(dtype)
    full = epi_lib.fused_decode_epilogue(x, wmat, *epi[1:])
    for b in (1, 2):
        part = epi_lib.fused_decode_epilogue(x[:b].contiguous(), wmat,
                                             *epi[1:])
        assert torch.equal(part[0], full[0][:b])
        assert torch.equal(part[1], full[1][:b])
    last = epi_lib.fused_decode_epilogue(x[3:].contiguous(), wmat, *epi[1:])
    assert torch.equal(last[0], full[0][3:])


@pytest.mark.gpu
def test_launch_counter_counts_kernel_launches_only(cuda, epi):
    x = _x((1, 6, 12, 64), cuda)
    epi_lib.reset_launch_counts()
    epi_lib.epilogue_reference(x, *epi)
    assert epi_lib.launch_counts == {"fused_decode_epilogue": 0}
    epi_lib.fused_decode_epilogue(x, *epi)
    epi_lib.fused_decode_epilogue(x.bfloat16(), epi.wmat.bfloat16(),
                                  *epi[1:])
    assert epi_lib.launch_counts == {"fused_decode_epilogue": 2}


@pytest.mark.gpu
def test_a_failed_build_raises_on_a_cuda_tensor(cuda, epi, monkeypatch):
    """No fallback: when the kernel cannot be built, a CUDA tensor raises and
    never reaches the plain version."""
    def no_build(*_):
        raise RuntimeError("nvcc failed (simulated)")

    def refuse(*_):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(native_build, "build", no_build)
    monkeypatch.setattr(epi_lib, "epilogue_reference", refuse)
    epi_lib.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            epi_lib.fused_decode_epilogue(_x((1, 6, 12, 64), cuda), *epi)
    finally:
        epi_lib.load_library.cache_clear()


@pytest.mark.gpu
def test_wrapper_refuses_mixed_dtypes_on_the_card(cuda, epi):
    with pytest.raises(TypeError, match="one dtype"):
        epi_lib.fused_decode_epilogue(_x((1, 6, 12, 64), cuda).bfloat16(),
                                      *epi)
