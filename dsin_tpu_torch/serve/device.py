"""The device half of side-information serving (counterpart of the JAX
package's `serve/service.py:483-553`, `_make_batched_fns` and
`_make_si_fns`).

`DeviceServer` holds one model on one device and runs the device functions
of serving:
  * `encode_symbols(x) -> symbols`: encoder -> heatmap gate -> quantizer ->
    int32 symbols, the service's batched encode (the rANS streams come
    from the codec);
  * `encode(x) -> (symbols, bpp_estimate)`: the same plus the probclass
    bitcost of those symbols as a bits-per-pixel estimate;
  * `decode(symbols) -> image`: centers lookup -> decoder -> clip, the
    service's AE-only batched decode;
  * `open_session(y) -> SidePrep`: once per side image, AE(y) -> y-hat, then
    `build_side_prep` (an L2 prep under `use_L2andLAB`; with the kernel's
    operands when a Pearson search runs through the kernel);
  * `decode_si(symbols, prep) -> image`: centers lookup -> decoder ->
    prepped patch search -> siNet -> clip; `with_scores=True` also returns
    the winning Pearson score per patch (the JAX package's
    `_make_si_fns(with_scores)`, the SI-match quality signal) on the routes
    that have them.
`serve/service.py` (`CompressionService`) batches requests onto these
functions; each model version it holds (a hot swap keeps up to three:
current, previous and staged) has a `DeviceServer` of its own, its weights
loaded on the caller's thread and `sync`ed before any worker reads them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from dsin_tpu_torch.coding.loader import build_at_rung
from dsin_tpu_torch.models.dsin import DSIN
from dsin_tpu_torch.models.quantizer import centers_lookup
from dsin_tpu_torch.ops import sifinder as sifinder_lib


class DeviceServer:
    """One DSIN model on one device, serving encode / open_session /
    decode_si. `device` defaults to the card and raises without one. The
    weights are seeded; `model.load_state_dict` replaces them (e.g. with
    `bridge.state_dict_from_jax`). `precision` is the ladder rung the model
    is built on (`coding/precision.py`, through the loader's path); inputs
    stay float32, and the search runs on the decoder's float32 output at
    every rung."""

    def __init__(self, ae_config, pc_config, device="cuda", seed: int = 0,
                 precision: str = "fp32"):
        self._bind(build_at_rung(ae_config, pc_config, device=device,
                                 seed=seed, precision=precision)[0])

    @classmethod
    def for_model(cls, model: DSIN) -> "DeviceServer":
        """Serve an already built model (`coding/loader.load_model_state`),
        on the model's device."""
        server = cls.__new__(cls)
        server._bind(model)
        return server

    def _bind(self, model: DSIN) -> None:
        self.model = model
        self.device = model.centers.device
        self.config = model.ae_config
        self.patch = tuple(int(v) for v in self.config.y_patch_size)
        self.use_l2 = sifinder_lib.use_l2(self.config)
        self.for_kernel = sifinder_lib.prep_for_kernel(self.config,
                                                       self.device)
        self._factors: Dict[Tuple[int, int], Optional[tuple]] = {}

    def sync(self) -> None:
        """Wait until everything issued on the caller's stream has run: the
        weights a hot swap loaded onto the device and the warm that read
        them. A bundle is staged only after this, so a worker's stream
        (another stream, on another thread) never reads half-copied
        weights after the commit. A no-op on the CPU."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _mask_factors(self, h: int, w: int):
        """Prior factors per image shape (None without `use_gauss_mask`)."""
        if (h, w) not in self._factors:
            self._factors[(h, w)] = (
                sifinder_lib.gaussian_position_mask_factors(h, w, *self.patch)
                if bool(self.config.use_gauss_mask) else None)
        return self._factors[(h, w)]

    @torch.inference_mode()
    def encode_symbols(self, x) -> torch.Tensor:
        """x (N, H, W, 3) in [0, 255] -> symbols (N, H/8, W/8, C) int32."""
        return self.model.encode(self._tensor(x)).symbols

    @torch.inference_mode()
    def encode(self, x):
        """x (N, H, W, 3) in [0, 255] -> (symbols (N, H/8, W/8, C) int32,
        bpp_estimate (N,) float32)."""
        x = self._tensor(x)
        symbols = self.encode_symbols(x)
        bits = self.model.bitcost(centers_lookup(self.model.centers, symbols),
                                  symbols)
        bpp = bits.sum(dim=(1, 2, 3)) / (x.shape[1] * x.shape[2])
        return symbols, bpp

    @torch.inference_mode()
    def decode(self, symbols) -> torch.Tensor:
        """symbols (N, H/8, W/8, C) -> images (N, H, W, 3) in [0, 255]:
        the autoencoder's reconstruction, no side information."""
        symbols = torch.as_tensor(symbols, device=self.device)
        x_dec = self.model.decode(centers_lookup(self.model.centers, symbols))
        return torch.clamp(x_dec, 0.0, 255.0)

    @torch.inference_mode()
    def open_session(self, y) -> sifinder_lib.SidePrep:
        """y (H, W, 3) in [0, 255] -> the session's SidePrep."""
        y = self._tensor(y)
        y_dec = self.model.decode(self.model.encode(y[None]).qbar)[0]
        return sifinder_lib.build_side_prep(
            y, y_dec, *self.patch, use_l2=self.use_l2,
            mask_factors=self._mask_factors(y.shape[0], y.shape[1]),
            for_kernel=self.for_kernel,
            conv_dtype=sifinder_lib.sifinder_conv_dtype(self.config))

    @torch.inference_mode()
    def decode_si(self, symbols, prep: sifinder_lib.SidePrep,
                  with_scores: bool = False):
        """symbols (N, H/8, W/8, C) -> x_with_si (N, H, W, 3) in [0, 255];
        with `with_scores`, (x_with_si, best_scores (N, P)): the search's
        winning scores, on the 'torch' and 'tiled' routes ('auto' takes
        'torch'); x_with_si is bit-identical with the flag on or off on one
        route."""
        symbols = torch.as_tensor(symbols, device=self.device)
        x_dec = self.model.decode(centers_lookup(self.model.centers, symbols))
        out = sifinder_lib.synthesize_side_image_prepped(
            x_dec, prep, *self.patch, self.config, with_scores=with_scores)
        y_syn, scores = out if with_scores else (out, None)
        image = torch.clamp(self.model.apply_sinet(x_dec, y_syn), 0.0, 255.0)
        return (image, scores) if with_scores else image
