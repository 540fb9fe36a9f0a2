"""Real bitstream codec for the quantized bottleneck (counterpart of the JAX
package's `coding/codec.py`).

Per-position PMFs of the causal context model (models/probclass.py) over the
L quantizer centers are quantized to integer frequency tables and fed to the
rANS coder (`coding/rans.py`). Encode knows every symbol up front, but each
PMF must be byte-identical to what the decoder computes from its partially
decoded buffer, so both sides run the SAME engine over the SAME buffer
states and the SAME softmax + quantization (`_tables_from_logits`).

Positions are coded in wavefronts: t = a*d + b*h + w with b = pad+1 and
a = pad*(b+1)+1 (t = 25d + 5h + w at K = 3). Every causal dependency of a
position lies in a strictly earlier front (see `_wavefronts`), so all PMFs of
one front come from one batched call; only the rANS symbol step stays
sequential. The engine defines the symbol order and the exact PMF floats, so
it is a property of the stream: the header's mode byte.

Stream modes (the DTPC header is the JAX package's, unchanged):

* **2, wavefront_np** (default): the pure-numpy incremental engine
  (`coding/incremental.py`). It is the JAX package's numpy code on the same
  float32 weight matrices, so mode-2 streams are **byte-identical across
  the two packages**, in both directions.
* **3, wavefront_pl**: each front's context blocks go through the fused
  front kernel (`coding/probclass_kernel.py`, K3), on the card for a codec
  on the card, through its plain torch version for a codec on the CPU.
  Mode 3 keeps the JAX package's same-process contract: a stream decodes
  exactly wherever the same engine encoded it (the card kernel for the
  card, the plain version for the CPU). The two engines differ in the last
  ulp, as the Pallas kernel in interpret mode and on a TPU already do under
  the same byte.
* 0 (sequential) and 1 (wavefront) are the JAX package's jit cross-check
  engines; they are not ported, and decoding or encoding them raises a
  typed ValueError that names the mode.
"""

from __future__ import annotations

import struct
import threading
from typing import Tuple

import numpy as np

from dsin_tpu_torch.coding import rans
from dsin_tpu_torch.coding.incremental import (IncrementalResShallow,
                                               wavefront_coeffs)
from dsin_tpu_torch.coding.probclass_kernel import ProbclassFrontKernel
from dsin_tpu_torch.models import probclass as pc_lib
from dsin_tpu_torch.runtime import resolve_device

MAGIC = b"DTPC"
VERSION = 2
HEADER_LEN = 13
MODE_SEQUENTIAL = 0
MODE_WAVEFRONT = 1
MODE_WAVEFRONT_NP = 2
MODE_WAVEFRONT_PL = 3
_MODES = {"sequential": MODE_SEQUENTIAL, "wavefront": MODE_WAVEFRONT,
          "wavefront_np": MODE_WAVEFRONT_NP,
          "wavefront_pl": MODE_WAVEFRONT_PL}
_MODE_NAMES = {mid: name for name, mid in _MODES.items()}


def front_bucket(n: int, max_bucket: int) -> int:
    """Rows of the batch a front of n context blocks is padded to: the next
    power of two, capped at the largest front. A deterministic function of
    n, so encode and decode run identical batches per front; not the
    largest front, because padded rows are wasted work."""
    return min(1 << (n - 1).bit_length(), max_bucket)


class BottleneckCodec:
    """Encode/decode one bottleneck symbol volume (D=C, H, W) with the
    context model.

    `weights` are the four pre-masked pairs of
    `probclass.front_weight_matrices`; `centers` the (L,) quantizer centers
    that decoded symbols map through to rebuild the volume the context model
    conditions on; `pc_config` gives kernel_size and use_centers_for_padding.
    `device` is where mode 3 runs its front kernel: the card by default,
    raising without one; only `device="cpu"` runs its plain version.
    """

    @classmethod
    def for_model(cls, model, scale_bits: int = rans.DEFAULT_SCALE_BITS):
        """From a DSIN model (`models/dsin.py`), on the model's device: the
        one construction every call site shares."""
        return cls(pc_lib.front_weight_matrices(model.probclass),
                   model.centers.detach().cpu().numpy(), model.pc_config,
                   scale_bits=scale_bits, device=model.centers.device)

    def __init__(self, weights, centers, pc_config,
                 scale_bits: int = rans.DEFAULT_SCALE_BITS, device="cuda"):
        self.device = resolve_device(device)
        self.weights = [(np.asarray(w, np.float32), np.asarray(b, np.float32))
                        for w, b in weights]
        self.centers = np.asarray(centers, dtype=np.float32)
        self.num_centers = len(self.centers)
        self.pc_config = pc_config
        self.scale_bits = scale_bits
        self.kernel_size = int(pc_config.kernel_size)
        self.pad = pc_lib.context_size(self.kernel_size) // 2
        self.ctx_shape = pc_lib.context_shape(self.kernel_size)
        self.pad_value = float(pc_lib.auto_pad_value(pc_config,
                                                     self.centers))
        self._engine_lock = threading.Lock()
        self._incremental = None     # built at first use, under the lock
        self._front_kernel = None

    def _incremental_engine(self):
        with self._engine_lock:
            if self._incremental is None:
                self._incremental = IncrementalResShallow(
                    self.weights, self.centers, self.kernel_size,
                    self.pad_value)
            return self._incremental

    def _front_kernel_engine(self):
        with self._engine_lock:
            if self._front_kernel is None:
                self._front_kernel = ProbclassFrontKernel(self.weights,
                                                          self.device)
            return self._front_kernel

    def thread_clone(self) -> "BottleneckCodec":
        """A per-thread twin for entropy pools (`serve/service.py`): shares
        this codec's read-only weights, its incremental engine (whose
        schedule cache is lock-guarded, so clones reuse the schedules the
        parent's warmup built) and its front kernel, while every encode /
        decode call keeps its per-pass buffers private."""
        clone = BottleneckCodec(self.weights, self.centers, self.pc_config,
                                scale_bits=self.scale_bits,
                                device=self.device)
        clone._incremental = self._incremental_engine()
        with self._engine_lock:
            # read-only once built; may still be None (lazy)
            clone._front_kernel = self._front_kernel
        return clone

    # -- internals ----------------------------------------------------------

    def _make_buffer(self, d: int, h: int, w: int) -> np.ndarray:
        """Padded q buffer, all pad_value: depth-front + H/W-both padding
        (as `probclass.pad_volume`)."""
        p = self.pad
        return np.full((d + p, h + 2 * p, w + 2 * p), self.pad_value,
                       dtype=np.float32)

    def _tables_from_logits(self, logits_batch: np.ndarray):
        """(n, L) float64 logits -> (freqs (n, L) u32, cum (n, L+1) u32).
        The ONE softmax + quantize path every engine shares: the stream
        format depends on encode, decode and ideal_bits hitting
        bit-identical tables, so there is exactly one copy of it. The
        softmax runs in float64 on the host."""
        z = logits_batch - logits_batch.max(axis=1, keepdims=True)
        pmf = np.exp(z)
        pmf /= pmf.sum(axis=1, keepdims=True)
        freqs_b = rans.quantize_pmf_batch(pmf, self.scale_bits)
        return freqs_b, rans.cum_from_freqs_batch(freqs_b)

    def _wavefronts(self, d: int, h: int, w: int):
        """Group positions into dependency-safe fronts.

        t(d, h, w) = a*d + b*h + w with b = pad+1 and a = pad*(b+1)+1.
        Any causal dependency (d', h', w') of (d, h, w) satisfies one of
          d'=d, h'=h, w'<w          -> t-t' = w-w'          >= 1
          d'=d, h'<h, w'<=w+pad     -> t-t' >= b - pad       = 1
          d'<d, h'<=h+pad, w'<=w+pad-> t-t' >= a - b*pad-pad = 1
        so equal-t positions are mutually independent. Returns a list of
        (n_i, 3) int arrays, t ascending, raster order within a front."""
        # shared with the numpy engine's schedule builder: the two engines'
        # fronts must coincide (same symbol order in the stream format)
        a_coef, b_coef = wavefront_coeffs(self.pad)
        dd, hh, ww = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                                 indexing="ij")
        pos = np.stack([dd, hh, ww], axis=-1).reshape(-1, 3)
        t = a_coef * pos[:, 0] + b_coef * pos[:, 1] + pos[:, 2]
        # stable sort keeps raster order inside equal-t groups
        order = np.argsort(t, kind="stable")
        pos, t = pos[order], t[order]
        bounds = np.flatnonzero(np.diff(t)) + 1
        return np.split(pos, bounds)

    def _wavefront_pass(self, shape: Tuple[int, int, int], front_symbols,
                        logits_fn):
        """Wavefront driver over context blocks: for each front (t
        ascending) gather its (cd, cs, cs) blocks from a sliding-window
        VIEW of the buffer (which sees each front's write-back), pad them
        to the front's bucket, get the logits from `logits_fn(blocks) ->
        (bucket, L)` in one call, obtain the front's symbols via
        `front_symbols(front, cum_b, freqs_b) -> (n,) ints` (encode: a
        gather from the known volume; decode: one native rANS call), write
        their centers back, and yield (front (n,3), symbols (n,), cum_b
        (n,L+1), freqs_b (n,L))."""
        d, h, w = shape
        buf = self._make_buffer(d, h, w)
        p = self.pad
        cd, cs, _ = self.ctx_shape
        win = np.lib.stride_tricks.sliding_window_view(buf, (cd, cs, cs))
        fronts = self._wavefronts(d, h, w)
        max_bucket = max(len(f) for f in fronts)
        blocks = np.zeros((max_bucket, cd, cs, cs), dtype=np.float32)
        for front in fronts:
            n = len(front)
            bucket = front_bucket(n, max_bucket)
            blocks[:n] = win[front[:, 0], front[:, 1], front[:, 2]]
            blocks[n:bucket] = 0.0  # deterministic padding
            logits = np.asarray(logits_fn(blocks[:bucket]),
                                dtype=np.float64)[:n]
            freqs_b, cum_b = self._tables_from_logits(logits)
            s = np.asarray(front_symbols(front, cum_b, freqs_b),
                           dtype=np.int64)
            buf[front[:, 0] + p, front[:, 1] + p, front[:, 2] + p] = \
                self.centers[s]
            yield front, s, cum_b, freqs_b

    def _wavefront_pass_np(self, shape: Tuple[int, int, int], front_symbols):
        """Same contract as `_wavefront_pass` (identical fronts, identical
        yield tuples), with PMFs from the numpy incremental engine."""
        vp = self._incremental_engine().begin(shape)
        for i, (_, front) in enumerate(vp.sch.fronts):
            logits = vp.logits_for(i).astype(np.float64)
            freqs_b, cum_b = self._tables_from_logits(logits)
            s = np.asarray(front_symbols(front, cum_b, freqs_b),
                           dtype=np.int64)
            vp.write(i, s)
            yield front, s, cum_b, freqs_b

    def _wavefront_pass_pl(self, shape: Tuple[int, int, int], front_symbols):
        """`_wavefront_pass` with PMFs from the fused front kernel (K3): one
        launch per front."""
        return self._wavefront_pass(
            shape, front_symbols,
            logits_fn=self._front_kernel_engine().front_logits)

    def _passes_for(self, mode_id: int):
        """Front-pass driver of a stream mode: the ONE mode -> engine map
        that encode, decode and ideal_bits share."""
        if mode_id in (MODE_SEQUENTIAL, MODE_WAVEFRONT):
            raise ValueError(
                f"stream mode {mode_id} ({_MODE_NAMES[mode_id]}) is one of "
                f"the JAX package's jit cross-check engines, which this "
                f"package does not port; it codes modes 2 (wavefront_np) "
                f"and 3 (wavefront_pl)")
        return {MODE_WAVEFRONT_NP: self._wavefront_pass_np,
                MODE_WAVEFRONT_PL: self._wavefront_pass_pl}[mode_id]

    @staticmethod
    def _mode_id(mode: str) -> int:
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of "
                             f"{sorted(_MODES)}")
        return _MODES[mode]

    # -- public API ---------------------------------------------------------

    def _encode_lane(self, symbols: np.ndarray, mode_id: int):
        """Run the passes for one volume and return its (starts, freqs)
        rANS lane: the per-volume half of encode, shared by the single and
        the batch entry points."""
        starts = np.empty(symbols.size, dtype=np.uint32)
        freqs_out = np.empty(symbols.size, dtype=np.uint32)
        passes = self._passes_for(mode_id)
        idx = 0
        known = lambda front, cum_b, freqs_b: \
            symbols[front[:, 0], front[:, 1], front[:, 2]]
        for front, s, cum_b, freqs_b in passes(symbols.shape, known):
            n = len(front)
            ar = np.arange(n)
            starts[idx:idx + n] = cum_b[ar, s]
            freqs_out[idx:idx + n] = freqs_b[ar, s]
            idx += n
        return starts, freqs_out

    def _check_symbols(self, symbols_dhw) -> np.ndarray:
        symbols = np.asarray(symbols_dhw)
        if symbols.ndim != 3:
            raise ValueError(f"expected (D, H, W) symbols, got "
                             f"{symbols.shape}")
        if symbols.size == 0:
            # _parse_header rejects d*h*w == 0 streams
            raise ValueError(f"empty symbol volume {symbols.shape}")
        if symbols.min() < 0 or symbols.max() >= self.num_centers:
            raise ValueError("symbol out of range")
        return symbols

    def _header(self, mode_id: int, shape) -> bytes:
        return MAGIC + struct.pack("<BBBHHH", VERSION, mode_id,
                                   self.scale_bits, *shape)

    def encode(self, symbols_dhw: np.ndarray,
               mode: str = "wavefront_np") -> bytes:
        """symbols (D=C, H, W) int -> framed bitstream. The mode is recorded
        in the stream header; decode always uses the stream's own
        engine."""
        symbols = self._check_symbols(symbols_dhw)
        mode_id = self._mode_id(mode)
        starts, freqs_out = self._encode_lane(symbols, mode_id)
        payload = rans.encode(starts, freqs_out, self.scale_bits)
        return self._header(mode_id, symbols.shape) + payload

    def encode_batch(self, volumes, mode: str = "wavefront_np") -> list:
        """N independent (D, H, W) symbol volumes -> N framed bitstreams with
        ONE native rANS call for the whole batch (ragged shapes are fine).
        Streams are byte-identical to N `encode` calls."""
        vols = [self._check_symbols(v) for v in volumes]
        mode_id = self._mode_id(mode)
        lanes = [self._encode_lane(v, mode_id) for v in vols]
        payloads = rans.encode_batch([ln[0] for ln in lanes],
                                     [ln[1] for ln in lanes],
                                     self.scale_bits)
        return [self._header(mode_id, v.shape) + p
                for v, p in zip(vols, payloads)]

    def _parse_header(self, bitstream: bytes):
        """Validate a DTPC frame; -> (mode_id, (d, h, w)). Every corruption
        raises a typed ValueError."""
        if len(bitstream) < HEADER_LEN:
            raise ValueError(f"truncated DTPC stream: {len(bitstream)} "
                             f"bytes < 13-byte header")
        if bitstream[:4] != MAGIC:
            raise ValueError("bad magic")
        version, mode_id, scale_bits, d, h, w = struct.unpack(
            "<BBBHHH", bitstream[4:HEADER_LEN])
        if version != VERSION:
            raise ValueError(f"unsupported bitstream version {version}")
        if mode_id not in _MODE_NAMES:
            raise ValueError(f"unknown scan mode {mode_id}")
        if scale_bits != self.scale_bits:
            raise ValueError(f"stream scale_bits {scale_bits} != codec "
                             f"{self.scale_bits}")
        if d * h * w == 0 or d * h * w > (1 << 28):
            # a corrupt header's dims would otherwise drive a giant
            # allocation and hours of decode
            raise ValueError(f"implausible symbol volume ({d}, {h}, {w}) "
                             f"in stream header")
        return mode_id, (d, h, w)

    def decode(self, bitstream: bytes) -> np.ndarray:
        """Framed bitstream -> symbols (D, H, W) int32, through the engine
        the stream header names."""
        mode_id, (d, h, w) = self._parse_header(bitstream)
        passes = self._passes_for(mode_id)
        symbols = np.empty((d, h, w), dtype=np.int32)
        with rans.Decoder(bitstream[HEADER_LEN:], self.scale_bits) as dec:
            take = lambda front, cum_b, freqs_b: dec.decode_front(cum_b)
            for front, s, _, _ in passes((d, h, w), take):
                symbols[front[:, 0], front[:, 1], front[:, 2]] = s
        return symbols

    def decode_batch(self, streams) -> list:
        """N framed bitstreams -> N (D, H, W) int32 volumes, each decoded by
        `decode` through its own header's engine (mixed shapes and modes are
        fine)."""
        return [self.decode(b) for b in streams]

    def coding_gap(self, symbols_dhw: np.ndarray, stream: bytes) -> dict:
        """Realized stream size vs this codec's own bound under the
        quantized tables. `stream` must be a DTPC frame this codec produced
        for `symbols_dhw`; its header's mode picks the engine of the
        `ideal_bits` pass. Returns payload bits (the 13 header bytes
        excluded), the bound, and the gap both absolute and relative."""
        mode_id, shape = self._parse_header(stream)
        symbols = np.asarray(symbols_dhw)
        if tuple(symbols.shape) != shape:
            raise ValueError(f"symbols {tuple(symbols.shape)} are not the "
                             f"volume this stream frames {shape}")
        ideal = self.ideal_bits(symbols, mode=_MODE_NAMES[mode_id])
        payload_bits = (len(stream) - HEADER_LEN) * 8
        gap_bits = payload_bits - ideal
        return {
            "payload_bits": payload_bits,
            "ideal_bits": round(ideal, 3),
            "gap_bits": round(gap_bits, 3),
            "gap_pct": round(100.0 * gap_bits / ideal, 4) if ideal > 0
            else 0.0,
        }

    def ideal_bits(self, symbols_dhw: np.ndarray,
                   mode: str = "wavefront_np") -> float:
        """Information content under the *quantized* tables of `mode`'s
        engine: the tight lower bound for that mode's stream."""
        passes = self._passes_for(self._mode_id(mode))
        symbols = np.asarray(symbols_dhw)
        scale = float(1 << self.scale_bits)
        known = lambda front, cum_b, freqs_b: \
            symbols[front[:, 0], front[:, 1], front[:, 2]]
        total = 0.0
        for _, s, _, freqs_b in passes(symbols.shape, known):
            total += float(np.sum(np.log2(
                scale / freqs_b[np.arange(len(s)), s].astype(np.float64))))
        return total


def encode_batch(codec: BottleneckCodec, symbols_nhwc: np.ndarray,
                 mode: str = "wavefront_np") -> list:
    """(N, H, W, C) NHWC symbols -> list of per-item bitstreams (one native
    rANS call for the batch). The volume depth axis is the bottleneck
    channel."""
    symbols = np.asarray(symbols_nhwc)
    return codec.encode_batch([np.transpose(s, (2, 0, 1)) for s in symbols],
                              mode=mode)


def decode_batch(codec: BottleneckCodec, streams: list) -> np.ndarray:
    """Inverse of encode_batch: list of bitstreams -> (N, H, W, C) int32."""
    vols = [np.transpose(v, (1, 2, 0))
            for v in codec.decode_batch(list(streams))]
    return np.stack(vols, axis=0)
