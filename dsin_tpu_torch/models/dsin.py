"""DSIN model bundle: autoencoder + entropy model + siNet (counterpart of the
JAX package's `models/dsin.py`).

The state_dict keeps the reference's partition names as top-level prefixes:
`encoder.*`, `decoder.*`, `centers`, `probclass.*` and `sinet.*` (sinet iff
not AE_only); the encoder/decoder batch statistics are the `running_mean` /
`running_var` buffers under `encoder.*` / `decoder.*`. `bridge.py` maps the
JAX trees onto these names.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dsin_tpu_torch.models import autoencoder as ae_lib
from dsin_tpu_torch.models import probclass as pc_lib
from dsin_tpu_torch.models import quantizer as quant_lib
from dsin_tpu_torch.models.sinet import SiNet, identity_kernel_
from dsin_tpu_torch.runtime import resolve_device


class DSIN(nn.Module):
    """Module bundle + inference forward pieces (NHWC in and out)."""

    def __init__(self, ae_config, pc_config):
        super().__init__()
        self.ae_config = ae_config
        self.pc_config = pc_config
        self.encoder = ae_lib.Encoder(ae_config)
        self.decoder = ae_lib.Decoder(ae_config)
        self.centers = nn.Parameter(torch.zeros(ae_config.num_centers))
        self.probclass = pc_lib.get_network_cls(pc_config)(
            pc_config, num_centers=ae_config.num_centers)
        self.ae_only = bool(ae_config.AE_only)
        self.sinet = (None if self.ae_only else
                      SiNet(dtype=ae_lib.compute_dtype(ae_config)))

    def init_weights(self, generator: torch.Generator) -> "DSIN":
        """Seeded init mirroring the reference's initializers: Xavier-uniform
        conv kernels, zero biases, unit/zero batch norm, identity siNet
        dilated convs, centers uniform over `centers_initial_range`. siNet
        draws last, so the autoencoder, probclass and centers get the same
        values from one seed with or without siNet (`AE_only`), as a stream
        written by an AE-only model must decode in a model with siNet.
        The weights are float32 whatever the compute dtype; a precision rung
        casts them afterwards (`coding/precision.py`)."""
        parts = [self.encoder, self.decoder, self.probclass, self.centers]
        if self.sinet is not None:
            parts.append(self.sinet)
        with torch.no_grad():
            for part in parts:
                if part is self.centers:
                    self.centers.copy_(quant_lib.init_centers(
                        self.ae_config.num_centers, generator,
                        self.ae_config.centers_initial_range))
                    continue
                for mod in part.modules():
                    if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d,
                                        pc_lib.MaskedConv3d)):
                        nn.init.xavier_uniform_(mod.weight,
                                                generator=generator)
                        if mod.bias is not None:
                            mod.bias.zero_()
                    elif isinstance(mod, nn.BatchNorm2d):
                        mod.reset_parameters()
            if self.sinet is not None:
                for conv in self.sinet.dilated_convs():
                    identity_kernel_(conv.weight)
        return self

    # -- forward pieces ------------------------------------------------------

    # encode and decode take their NHWC input contiguous: the convolutions
    # round differently for another memory layout of equal values. `train`
    # normalizes by batch statistics, which `stats` (a dict) records for
    # `autoencoder.apply_batch_stats`, and `batch` makes the global batch's
    # (see `autoencoder.batch_norm`).

    def encode(self, x: torch.Tensor, train: bool = False,
               stats: Optional[dict] = None,
               batch=None) -> ae_lib.EncoderOutput:
        return ae_lib.encode(self.encoder, x.contiguous(), self.centers,
                             train, stats, batch)

    def decode(self, q: torch.Tensor, train: bool = False,
               stats: Optional[dict] = None, batch=None) -> torch.Tensor:
        return self.decoder(q.contiguous(), train, stats, batch)

    def bitcost(self, q: torch.Tensor, symbols: torch.Tensor) -> torch.Tensor:
        pad = pc_lib.auto_pad_value(self.pc_config, self.centers)
        return pc_lib.bitcost(self.probclass, q, symbols, pad_value=pad)

    def apply_sinet(self, x_dec: torch.Tensor,
                    y_syn: torch.Tensor) -> torch.Tensor:
        """Fuse the decoded image with the synthesized side image: 6-channel
        normalized concat, denormalized 3-channel output (NHWC)."""
        style = self.ae_config.normalization
        concat = torch.cat([ae_lib.normalize_image(x_dec, style),
                            ae_lib.normalize_image(y_syn, style).detach()],
                           dim=-1)
        out = self.sinet(concat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return ae_lib.denormalize_image(out, style)


def build_model(ae_config, pc_config, device="cuda", seed: int = 0) -> DSIN:
    """A DSIN in inference mode on `device`, its weights drawn on the CPU from
    a `torch.Generator` seeded with `seed` (so every device gets the same
    weights). Raises when `device` is the card and none is present."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = DSIN(ae_config, pc_config).init_weights(gen)
    return model.to(dev).eval()
