"""The probclass front kernel (K3) and codec mode 3 on the card.

Every test here needs an NVIDIA card and nvcc; on a machine without a card
they skip (decided inside the `cuda` fixture, so every pytest-xdist worker
collects the same tests). This file imports no jax, so it also runs where
jax is absent:

    python -m pytest --noconftest -q tests/test_torch_codec_gpu.py

Tolerances: the kernel and its plain torch version sum the same fp32
products in another order, so logits agree within rtol/atol 1e-5 (the slack
tests/test_probclass_pallas.py:49 allows between Pallas and XLA); rows of
one block are bit-identical whatever the batch; mode-3 streams round-trip
exactly. NaN in every input no logit needs changes no logit bit: the
kernel reads only the positions `needed_positions` lists.
"""

import numpy as np
import pytest
import torch

from dsin_tpu_torch.coding import codec as codec_lib
from dsin_tpu_torch.coding import probclass_kernel as pk
from dsin_tpu_torch.entry import full_configs, tiny_configs
from dsin_tpu_torch.models import probclass as pc_lib

L = 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _context_model(full: bool, seed: int = 0, c=None):
    """A ResShallow with the model's seeded Xavier-uniform weights, random
    biases, and sorted centers; `c` overrides the config's width."""
    _, pc = full_configs() if full else tiny_configs()
    if c is not None:
        pc = pc.replace(arch_param__k=c)
    res = pc_lib.ResShallow(pc, L)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in (res.conv0, res.conv1, res.conv2, res.conv3):
            torch.nn.init.xavier_uniform_(conv.weight, generator=gen)
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen)
                            * 0.1)
    centers = np.sort(np.random.default_rng(seed).uniform(-2, 2, L))
    return pc, res, centers.astype(np.float32)


def _operands(res, centers, batch, dev, seed=1):
    weights = [(torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev))
               for w, b in pc_lib.front_weight_matrices(res)]
    blocks = np.random.default_rng(seed).choice(
        centers, size=(batch,) + pk.CONTEXT).astype(np.float32)
    return torch.from_numpy(blocks).to(dev), weights


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True], ids=["tiny", "pc_default"])
@pytest.mark.parametrize("batch", [1, 5, 64, 128, 248, 256, 300])
def test_kernel_matches_plain(cuda, full, batch):
    _, res, centers = _context_model(full)
    blocks, weights = _operands(res, centers, batch, cuda)
    got = pk.probclass_front_logits(blocks, weights)
    ref = pk.probclass_front_logits_reference(blocks, weights)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (batch, L)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_rows_are_bit_identical_across_batches(cuda):
    _, res, centers = _context_model(True)
    blocks, weights = _operands(res, centers, 256, cuda)
    full = pk.probclass_front_logits(blocks, weights)
    for b in (1, 5, 64, 128, 130, 248):
        assert torch.equal(pk.probclass_front_logits(
            blocks[:b].contiguous(), weights), full[:b])
    perm = torch.randperm(256, generator=torch.Generator().manual_seed(0))
    perm = perm.to(cuda)
    assert torch.equal(pk.probclass_front_logits(
        blocks[perm].contiguous(), weights), full[perm])
    padded = torch.cat([blocks[:3], torch.zeros_like(blocks[:5])])
    assert torch.equal(pk.probclass_front_logits(padded, weights)[:3],
                       full[:3])


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True], ids=["tiny", "pc_default"])
def test_nan_in_unneeded_inputs_changes_no_logit(cuda, full):
    _, res, centers = _context_model(full)
    blocks, weights = _operands(res, centers, 130, cuda)
    keep = torch.zeros(pk.CONTEXT, dtype=torch.bool)
    for p in pk.needed_positions(3)[0]:
        keep[p] = True
    drop = ~keep.to(cuda)
    nan = blocks.masked_fill(drop, float("nan"))
    zero = blocks.masked_fill(drop, 0.0)
    got = pk.probclass_front_logits(nan, weights)
    assert torch.isfinite(got).all()
    assert torch.equal(got, pk.probclass_front_logits(zero, weights))
    assert torch.equal(got, pk.probclass_front_logits(blocks, weights))


@pytest.mark.gpu
def test_prepared_params_equal_the_pairs(cuda):
    _, res, centers = _context_model(True)
    blocks, weights = _operands(res, centers, 64, cuda)
    params = pk.prepare_front(weights)
    assert params.buffer.device.type == "cuda"
    assert torch.equal(pk.probclass_front_logits(blocks, params),
                       pk.probclass_front_logits(blocks, weights))


@pytest.mark.gpu
def test_widths_off_the_float4_tile_give_the_plain_logits(cuda):
    """C = 6: the prepared buffer pads the channels to 8 with zero weights
    and biases. Padding moves no bit: the logits are torch.equal to the
    kernel's on the same model padded to 12 channels by hand (another
    buffer, the same real terms in the same order); they agree with the
    plain version within the K3 tolerance (its matmuls sum in another
    order); and C = 6 codes in mode 3 exactly."""
    pc, res, centers = _context_model(False, c=6)
    blocks, weights = _operands(res, centers, 130, cuda)
    params = pk.prepare_front(weights)
    assert params.layout["channels"] == 8
    got = pk.probclass_front_logits(blocks, params)
    wide = []
    for i, (w, b) in enumerate(weights):
        cin, cout = (1 if i == 0 else 6), w.shape[1]
        wp = w.new_zeros((18, 1 if i == 0 else 12, 12 if i < 3 else cout))
        wp[:, :cin, :cout] = w.reshape(18, cin, cout)
        bp = b.new_zeros(wp.shape[2])
        bp[:cout] = b
        wide.append((wp.reshape(-1, wp.shape[2]), bp))
    assert pk.prepare_front(wide).layout["channels"] == 12
    assert torch.equal(got, pk.probclass_front_logits(blocks, wide))
    torch.testing.assert_close(
        got, pk.probclass_front_logits_reference(blocks, weights),
        rtol=1e-5, atol=1e-5)
    codec = codec_lib.BottleneckCodec(pc_lib.front_weight_matrices(res),
                                      centers, pc, device=cuda)
    symbols = np.random.default_rng(4).integers(0, L, (8, 5, 6))
    pk.reset_launch_counts()
    stream = codec.encode(symbols, mode="wavefront_pl")
    assert pk.launch_counts["probclass_front_logits"] == len(
        codec._wavefronts(*symbols.shape))
    np.testing.assert_array_equal(codec.decode(stream), symbols)


@pytest.mark.gpu
def test_launch_counter_counts_kernel_launches_only(cuda):
    _, res, centers = _context_model(False)
    blocks, weights = _operands(res, centers, 8, cuda)
    pk.reset_launch_counts()
    pk.probclass_front_logits_reference(blocks, weights)
    assert pk.launch_counts == {"probclass_front_logits": 0}
    pk.probclass_front_logits(blocks, weights)
    pk.probclass_front_logits(blocks, weights)
    assert pk.launch_counts == {"probclass_front_logits": 2}


@pytest.mark.gpu
def test_wrapper_refuses_bf16(cuda):
    _, res, centers = _context_model(False)
    blocks, weights = _operands(res, centers, 4, cuda)
    with pytest.raises(TypeError, match="float32"):
        pk.probclass_front_logits(blocks.bfloat16(), weights)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 5, 6), (32, 5, 19)])
def test_mode3_round_trip_on_the_card(cuda, shape, monkeypatch):
    """One K3 launch per front and pass; exact symbols back; the plain
    version is never reached by a codec on the card."""
    pc, res, centers = _context_model(shape[0] == 32)
    codec = codec_lib.BottleneckCodec(pc_lib.front_weight_matrices(res),
                                      centers, pc, device=cuda)

    def refuse(*_):
        raise AssertionError("a codec on the card reached the plain K3")

    monkeypatch.setattr(pk, "probclass_front_logits_reference", refuse)
    symbols = np.random.default_rng(2).integers(0, L, shape)
    fronts = len(codec._wavefronts(*shape))
    pk.reset_launch_counts()
    stream = codec.encode(symbols, mode="wavefront_pl")
    assert pk.launch_counts["probclass_front_logits"] == fronts
    assert stream[5] == codec_lib.MODE_WAVEFRONT_PL
    assert codec.encode(symbols, mode="wavefront_pl") == stream
    np.testing.assert_array_equal(codec.decode(stream), symbols)
    assert pk.launch_counts["probclass_front_logits"] == 3 * fronts
    ideal2 = codec.ideal_bits(symbols)
    assert abs(codec.ideal_bits(symbols, mode="wavefront_pl")
               - ideal2) <= 1e-3 * ideal2


@pytest.mark.gpu
def test_decode_is_deterministic_on_the_card(cuda):
    """Equal symbols decode to bit-equal images from call to call (the
    entry points pin cuDNN to deterministic algorithms)."""
    from dsin_tpu_torch.models.dsin import build_model
    from dsin_tpu_torch.models.quantizer import centers_lookup
    ae, pc = full_configs()
    model = build_model(ae, pc, device=cuda, seed=0)
    symbols = torch.from_numpy(np.random.default_rng(3).integers(
        0, L, (2, 40, 153, 32)).astype(np.int32)).to(cuda)
    with torch.inference_mode():
        q = centers_lookup(model.centers, symbols)
        first = model.decode(q)
        assert all(torch.equal(model.decode(q), first) for _ in range(3))
