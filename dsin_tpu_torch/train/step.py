"""The eval forward of DSIN with its losses and metrics (counterpart of the
JAX package's `train/step.py` `_forward_losses` with `train=False`,
`make_eval_step` and `make_inference_step`).

encode -> decode, the side image's inference-mode encode and decode, the
patch search under the position prior, siNet, the distortions with the
train cast rules (the reference reuses the training distortion at eval),
the bitcost -> bpp and the rate and regularization losses:
`loss = total + si_weight * L1(x, x_with_si)`. The train step (its
backward pass, optimizers and the loop) is not ported yet.

The prior is checked once per step built (`ops/sifinder.check_mask`), not
per image: the check of a 320x1224 Gaussian prior reads its 1.18 GB.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dsin_tpu_torch.models.probclass import bitcost_to_bpp
from dsin_tpu_torch.ops import metrics as metrics_lib
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.train import losses as loss_lib
from dsin_tpu_torch.train.checkpoint import TRAINING_ITEM

SCALAR_METRICS = ("bpp", "H_real", "H_soft", "pc_loss", "d_loss", "mae",
                  "psnr", "si_l1")


def forward_losses(model, x: torch.Tensor, y: torch.Tensor, si_mask,
                   train: bool = False):
    """The shared forward: (loss, aux dict), for NHWC float32 batches in
    [0, 255] on the model's device. `si_mask` is None, an (Hc, Wc, P) prior
    or a `CheckedMask`."""
    if train:
        raise NotImplementedError(
            f"the train branch (BN in train mode, gradients) waits for "
            f"training in the port ({TRAINING_ITEM})")
    cfg = model.ae_config
    enc = model.encode(x)
    x_dec = model.decode(enc.qbar)
    if model.ae_only:
        x_with_si = torch.zeros_like(x)
        y_syn = None
        si_l1 = torch.zeros((), device=x.device)
        si_weight = 0.0
    else:
        y_dec = model.decode(model.encode(y).qbar)
        ph, pw = (int(v) for v in cfg.y_patch_size)
        y_syn = sifinder_lib.synthesize_side_image(x_dec, y, y_dec, si_mask,
                                                   ph, pw, cfg)
        x_with_si = model.apply_sinet(x_dec, y_syn)
        si_l1 = loss_lib.si_l1_loss(x, x_with_si)
        si_weight = cfg.si_weight

    # the train cast rules even at eval, as the reference's eval loss
    dist = metrics_lib.compute_distortions(cfg, x, x_dec, is_training=True)
    d_scaled = (1.0 - si_weight) * dist.d_loss_scaled
    bc = model.bitcost(enc.qbar, enc.symbols)
    bpp = bitcost_to_bpp(bc, x)
    rate = loss_lib.rate_loss(bc, enc.heatmap, cfg.H_target, cfg.beta)
    regs = loss_lib.regularization_losses(model, cfg, model.pc_config)
    total = loss_lib.total_loss(d_scaled, rate, regs)
    loss = total + si_weight * si_l1
    aux = {"symbols": enc.symbols, "bpp": bpp, "H_real": rate.H_real,
           "H_soft": rate.H_soft, "pc_loss": rate.pc_loss,
           "d_loss": dist.d_loss_scaled, "mae": dist.mae, "psnr": dist.psnr,
           "si_l1": si_l1, "x_dec": x_dec, "x_with_si": x_with_si,
           "y_syn": y_syn}
    return loss, aux


def _checked(model, si_mask):
    """The prior checked once, on the model's device."""
    if si_mask is None or isinstance(si_mask, sifinder_lib.CheckedMask):
        return si_mask
    ph, pw = (int(v) for v in model.ae_config.y_patch_size)
    return sifinder_lib.check_mask(
        torch.as_tensor(si_mask, device=model.centers.device), ph, pw)


def _as_batch(model, t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32,
                           device=model.centers.device)


def make_eval_step(model, si_mask: Optional[torch.Tensor] = None):
    """(x, y) -> the scalar metrics (`SCALAR_METRICS` and 'loss')."""
    mask = _checked(model, si_mask)

    @torch.inference_mode()
    def eval_step(x, y) -> Dict[str, torch.Tensor]:
        loss, aux = forward_losses(model, _as_batch(model, x),
                                   _as_batch(model, y), mask)
        metrics = {k: aux[k] for k in SCALAR_METRICS}
        metrics["loss"] = loss
        return metrics

    return eval_step


def make_inference_step(model, si_mask: Optional[torch.Tensor] = None):
    """(x, y) -> dict with x_dec, x_with_si, y_syn, bpp, loss, psnr, mae
    and symbols: the test run's full reconstruction fetch."""
    mask = _checked(model, si_mask)

    @torch.inference_mode()
    def infer(x, y) -> Dict[str, Optional[torch.Tensor]]:
        loss, aux = forward_losses(model, _as_batch(model, x),
                                   _as_batch(model, y), mask)
        return {"x_dec": aux["x_dec"], "x_with_si": aux["x_with_si"],
                "y_syn": aux["y_syn"], "bpp": aux["bpp"], "loss": loss,
                "psnr": aux["psnr"], "mae": aux["mae"],
                "symbols": aux["symbols"]}

    return infer
