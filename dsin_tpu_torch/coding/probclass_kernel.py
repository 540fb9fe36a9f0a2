"""One fused wavefront front of the probclass context model on the card
(counterpart of the JAX package's `coding/probclass_pallas.py`, K3).

The CUDA kernel is `csrc/probclass_front.cu` (its header gives the design
and its bound); this module builds it with `nvcc` at first use
(`native_build`), binds it with `ctypes`, and holds:

* `needed_positions(kernel_size)`: per layer, the positions that reach the
  one logit through the taps the causality masks keep and the residual
  skip; the one derivation of the tables the kernel walks, and of its bound
  (`needed_fmas`);
* `prepare_front(weights) -> FrontParams`: the compacted weights (masked
  rows dropped) and those tables packed into one device buffer, with the
  layout the kernel reads; prepared once per engine;
* `probclass_front_logits(blocks, weights)`: (B, 5, 9, 9) float32 context
  blocks -> (B, L) float32 logits through the four masked convs. A CUDA
  tensor launches the kernel or raises; a CPU tensor takes the plain
  version, and only a CPU tensor does;
* `probclass_front_logits_reference`, the same function in plain torch: the
  static tap loop of matmuls of the Pallas kernel's `_conv_taps`;
* `ProbclassFrontKernel`, the parameter-holding wrapper codec mode 3 uses.

`weights` are the four pre-masked (W (taps*Cin, Cout), b (Cout,)) pairs of
`models/probclass.front_weight_matrices`, as tensors on the blocks' device,
or a `FrontParams` prepared from them. The wrapper counts its launches in
`launch_counts`.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from dsin_tpu_torch import native_build
from dsin_tpu_torch.models import probclass as pc_lib

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "probclass_front.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SIZE = 3                            # the kernel's fixed filter geometry
CONTEXT = pc_lib.context_shape(KERNEL_SIZE)          # (5, 9, 9)
FILTER = pc_lib.filter_shape(KERNEL_SIZE)            # (2, 3, 3)
FILTER_TAPS = int(np.prod(FILTER))                   # 18

# one count per wrapper call that launches the kernel; never incremented by
# the plain version
launch_counts = {"probclass_front_logits": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class KernelLibrary(NamedTuple):
    front: Callable            # probclass_front_logits
    error_string: Callable
    path: str
    build_seconds: float       # 0.0 when the library was already built
    ptxas_log: str             # nvcc -Xptxas -v output of this build


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build `csrc/probclass_front.cu` into `build/` (keyed by a hash of the
    source and flags) unless already built, and bind it. Raises on
    failure, and when the library's layout differs from `LAYOUT_FIELDS`."""
    so, seconds, log = native_build.build(SOURCE, native_build.nvcc(),
                                          NVCC_FLAGS, "probclass_front")
    lib = ctypes.CDLL(str(so))
    if lib.probclass_front_layout_ints() != len(LAYOUT_FIELDS):
        raise RuntimeError(f"{so} takes {lib.probclass_front_layout_ints()} "
                           f"layout ints, this module builds "
                           f"{len(LAYOUT_FIELDS)}")
    front = lib.probclass_front_logits
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    front.argtypes = [ptr, ptr, ptr, i32, ptr, i32, ptr]
    front.restype = i32
    err_str = lib.probclass_front_error_string
    err_str.argtypes = [i32]
    err_str.restype = ctypes.c_char_p
    return KernelLibrary(front, err_str, str(so), seconds, log)


# -- what the logit needs ------------------------------------------------------

Position = Tuple[int, int, int]


def kept_taps(kernel_size: int, include_center: bool) -> List[Position]:
    """The (td, th, tw) taps the causality mask keeps, in raster order (the
    order of the weight matrices' rows): 13 for conv0, 14 for the others at
    K = 3."""
    mask = pc_lib.make_mask(kernel_size, include_center)
    return [tuple(int(v) for v in t) for t in np.argwhere(mask > 0)]


def _layer_taps(kernel_size: int) -> List[List[Position]]:
    return [kept_taps(kernel_size, i > 0) for i in range(4)]


def _shift(ps, taps) -> set:
    return {(p[0] + t[0], p[1] + t[1], p[2] + t[2]) for p in ps for t in taps}


def needed_positions(kernel_size: int) -> List[List[Position]]:
    """Per layer grid (input, act1, r1, act3), the positions that reach the
    one logit through the kept taps and the skip `act1[dd:, hw:-hw,
    hw:-hw]`, sorted. At K = 3: 294 of 405, 144 of 196, 56 of 75, 14 of
    18."""
    taps = _layer_taps(kernel_size)
    dd, hw = 2 * (kernel_size // 2), kernel_size - 1
    act3 = _shift([(0, 0, 0)], taps[3])
    r1 = _shift(act3, taps[2])
    act1 = _shift(r1, taps[1]) | _shift(act3, [(dd, hw, hw)])
    block = _shift(act1, taps[0])
    return [sorted(s) for s in (block, act1, r1, act3)]


def needed_fmas(channels: int, logits: int,
                kernel_size: int = KERNEL_SIZE) -> int:
    """Multiply-adds one block's logit row needs: each needed output of each
    layer over its kept taps and its inputs (611,424 at C = 24, L = 6)."""
    taps = _layer_taps(kernel_size)
    outs = [len(p) for p in needed_positions(kernel_size)[1:]] + [1]
    dims = [(1, channels), (channels, channels), (channels, channels),
            (channels, logits)]
    return sum(n * len(t) * cin * cout
               for n, t, (cin, cout) in zip(outs, taps, dims))


def _grids(kernel_size: int) -> List[Position]:
    """(D, H, W) of the input block and of each layer's output grid."""
    fd, fh, fw = pc_lib.filter_shape(kernel_size)
    grids = [pc_lib.context_shape(kernel_size)]
    for _ in range(4):
        d, h, w = grids[-1]
        grids.append((d - fd + 1, h - fh + 1, w - fw + 1))
    return grids


# -- the prepared buffer -------------------------------------------------------

# The kernel's `struct Layout`, field for field, in 4-byte words.
LAYOUT_FIELDS = (
    ("channels", "logits", "block_words", "seg_end0", "seg_end1", "seg_end2")
    + tuple(f"taps{i}" for i in range(4)) + tuple(f"ntaps{i}" for i in range(4))
    + tuple(f"pos{i}" for i in range(4)) + tuple(f"npos{i}" for i in range(4))
    + tuple(f"w{i}" for i in range(4)) + tuple(f"b{i}" for i in range(4))
    + ("smem_in", "smem_act1", "smem_r1", "smem_act3", "smem_words"))


class FrontParams(NamedTuple):
    """The kernel's operands besides the blocks, prepared once."""
    weights: list              # the four full (W, b) pairs: the plain version
    buffer: torch.Tensor       # float32 words: int32 tables + compacted weights
    layout: dict               # LAYOUT_FIELDS -> int


def _align4(n: int) -> int:
    return -(-n // 4) * 4


def prepare_front(weights) -> FrontParams:
    """Pack the tables and the compacted weights into one buffer on the
    weights' device. Three segments, each staged by one bulk copy: the
    tables with w0 and b0; w1 and b1; w2, b2, w3 and b3. Every piece starts
    on a 16-byte boundary. The compacted W keeps the kept taps' rows in
    their order: ((kept taps) * Cin, Cout)."""
    c, l_out = _check_weights(weights)
    ks = KERNEL_SIZE
    grids, taps = _grids(ks), _layer_taps(ks)
    outs = needed_positions(ks)[1:] + [[(0, 0, 0)]]
    dd, hw = 2 * (ks // 2), ks - 1

    def flat(grid, p):
        return (p[0] * grid[1] + p[1]) * grid[2] + p[2]

    lay = {"channels": c, "logits": l_out,
           "block_words": int(np.prod(CONTEXT))}
    tables = []            # (layout field, int32 words)
    for i in range(4):
        tables.append((f"taps{i}", np.array(
            [flat(grids[i], t) for t in taps[i]], np.int32)))
        lay[f"ntaps{i}"] = len(taps[i])
    for i in range(4):
        rows = [(flat(grids[i + 1], q), flat(grids[i], q),
                 flat(grids[1], (q[0] + dd, q[1] + hw, q[2] + hw))
                 if i == 2 else 0) for q in outs[i]]
        tables.append((f"pos{i}", np.array(rows, np.int32).ravel()))
        lay[f"npos{i}"] = len(outs[i])
    mats = []              # (layout field, float32 words)
    for i, (w, b) in enumerate(weights):
        rows = np.flatnonzero(pc_lib.make_mask(ks, i > 0).ravel())
        w = w.detach().cpu().numpy()
        kept = w.reshape(-1, w.shape[0] // FILTER_TAPS, w.shape[1])[rows]
        mats += [(f"w{i}", kept.ravel()), (f"b{i}", b.detach().cpu().numpy())]
    segments = [tables + mats[:2], mats[2:4], mats[4:]]
    words = 0
    for s, segment in enumerate(segments):
        for name, arr in segment:
            lay[name] = words
            words = _align4(words + arr.size)
        lay[f"seg_end{s}"] = words
    buf = np.zeros(words, np.float32)
    for name, arr in tables:
        buf.view(np.int32)[lay[name]:lay[name] + arr.size] = arr
    for name, arr in mats:
        buf[lay[name]:lay[name] + arr.size] = arr
    lay["smem_in"] = words
    lay["smem_act1"] = _align4(words + lay["block_words"])
    sizes = [int(np.prod(g)) * c for g in grids[1:4]]
    lay["smem_r1"] = lay["smem_act1"] + sizes[0]
    lay["smem_act3"] = lay["smem_r1"] + sizes[1]
    lay["smem_words"] = _align4(lay["smem_act3"] + sizes[2])
    device = weights[0][0].device
    return FrontParams(list(weights), torch.from_numpy(buf).to(device),
                       {k: int(lay[k]) for k in LAYOUT_FIELDS})


def _check_weights(weights) -> Tuple[int, int]:
    """Raise on (W, b) pairs the kernel does not take; -> (C, L)."""
    if len(weights) != 4:
        raise ValueError(f"expected 4 (W, b) pairs, got {len(weights)}")
    c = weights[0][0].shape[1]
    cins = (1, c, c, c)
    for i, ((w, b), cin) in enumerate(zip(weights, cins)):
        cout = w.shape[1] if w.dim() == 2 else -1
        if (tuple(w.shape) != (FILTER_TAPS * cin, cout)
                or tuple(b.shape) != (cout,)):
            raise ValueError(f"layer {i}: W {tuple(w.shape)} / b "
                             f"{tuple(b.shape)}, expected ({FILTER_TAPS * cin}, "
                             f"Cout) / (Cout,)")
        if i < 3 and cout != c:
            raise ValueError(f"layer {i} has {cout} outputs, conv0 has {c}")
    device = weights[0][0].device
    for t in (t for pair in weights for t in pair):
        if t.dtype != torch.float32:
            raise TypeError(f"{t.dtype} operand: the probclass front kernel "
                            "takes float32 only (entropy path)")
        if t.device != device:
            raise ValueError(f"weights on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    return c, weights[3][0].shape[1]


def _check_blocks(blocks: torch.Tensor, device: torch.device) -> None:
    if blocks.dtype != torch.float32:
        raise TypeError(f"{blocks.dtype} operand: the probclass front kernel "
                        "takes float32 only (entropy path)")
    if blocks.device != device:
        raise ValueError(f"operand on {device}, blocks on {blocks.device}")
    if not blocks.is_contiguous():
        raise ValueError("operands must be contiguous")
    if blocks.dim() != 4 or tuple(blocks.shape[1:]) != CONTEXT:
        raise ValueError(f"blocks {tuple(blocks.shape)}, expected (B,) + "
                         f"{CONTEXT}: the kernel is built for kernel_size "
                         f"{KERNEL_SIZE}")


def probclass_front_logits(blocks: torch.Tensor, weights):
    """(B, 5, 9, 9) float32 context blocks -> (B, L) float32 logits.
    `weights`: a `FrontParams`, or the four (W, b) pairs (prepared on each
    call that launches)."""
    params = weights if isinstance(weights, FrontParams) else None
    pairs = params.weights if params is not None else weights
    if params is None:
        _check_weights(pairs)
    _check_blocks(blocks, pairs[0][0].device)
    if blocks.device.type == "cpu":
        return probclass_front_logits_reference(blocks, pairs)
    if blocks.device.type != "cuda":
        raise ValueError(f"the probclass front kernel runs on CUDA tensors, "
                         f"got {blocks.device}")
    if params is None:
        params = prepare_front(pairs)
    if params.layout["channels"] % 4:
        raise ValueError(f"the probclass front kernel takes C a multiple of "
                         f"4 (float4 tiles), got {params.layout['channels']}")
    lib = load_library()
    b, lay = blocks.shape[0], params.layout
    out = torch.empty((b, lay["logits"]), dtype=torch.float32,
                      device=blocks.device)
    ints = (ctypes.c_int * len(LAYOUT_FIELDS))(*lay.values())
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        err = lib.front(blocks.data_ptr(), params.buffer.data_ptr(), ints,
                        len(LAYOUT_FIELDS), out.data_ptr(), b, stream)
    if err != 0:
        raise RuntimeError(f"probclass_front_logits launch failed: CUDA "
                           f"error {err} ({lib.error_string(err).decode()})")
    launch_counts["probclass_front_logits"] += 1
    return out


def _conv_taps(act: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """VALID masked conv as a static tap loop: act (B, D, H, W, Cin), w
    (taps*Cin, Cout) in (td, th, tw) row-major tap order."""
    bsz, d, h, wd, cin = act.shape
    fd, fh, fw = FILTER
    do, ho, wo = d - fd + 1, h - fh + 1, wd - fw + 1
    acc = torch.zeros((bsz * do * ho * wo, w.shape[1]), dtype=act.dtype,
                      device=act.device)
    tap = 0
    for td in range(fd):
        for th in range(fh):
            for tw in range(fw):
                sl = act[:, td:td + do, th:th + ho, tw:tw + wo, :]
                acc = acc + sl.reshape(-1, cin) @ w[tap * cin:(tap + 1) * cin]
                tap += 1
    return (acc + b).reshape(bsz, do, ho, wo, -1)


def probclass_front_logits_reference(blocks: torch.Tensor, weights):
    """The kernel's function in plain torch (the Pallas `_front_kernel`):
    conv0+ReLU, conv1+ReLU, conv2 + the cropped act1 skip, conv3+ReLU."""
    (w0, b0), (w1, b1), (w2, b2), (w3, b3) = weights
    act1 = torch.relu(_conv_taps(blocks[..., None], w0, b0))
    r1 = torch.relu(_conv_taps(act1, w1, b1))
    dd, hw = 2 * (KERNEL_SIZE // 2), KERNEL_SIZE - 1
    act3 = _conv_taps(r1, w2, b2) + act1[:, dd:, hw:-hw, hw:-hw, :]
    return torch.relu(_conv_taps(act3, w3, b3)).reshape(blocks.shape[0], -1)


class ProbclassFrontKernel:
    """Codec mode 3's engine: the pre-masked weights prepared once on
    `device` (`params`), and `front_logits(blocks) -> (B, L) float32 numpy`
    through `probclass_front_logits`. Read-only after construction."""

    def __init__(self, weights, device: torch.device):
        self.device = device
        self.params = prepare_front([(torch.as_tensor(w, device=device),
                                      torch.as_tensor(b, device=device))
                                     for w, b in weights])

    def front_logits(self, blocks: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(blocks, np.float32))
        return probclass_front_logits(x.to(self.device),
                                      self.params).cpu().numpy()
