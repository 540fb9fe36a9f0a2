"""Rate-distortion loss assembly (counterpart of the JAX package's
`train/losses.py`):

  H_real  = mean(bitcost)
  H_mask  = mean(bitcost * heatmap)         (heatmap gates where bits count)
  H_soft  = (H_mask + H_real) / 2
  pc_loss = beta * max(H_soft - H_target, 0)
  total   = d_loss_scaled + pc_loss + L2(enc) + L2(dec) + L2(centers) + L2(pc)
  loss    = total + si_weight * L1(x, x_with_si)     [/ batch_size if SI batch>1]

where d_loss_scaled already carries the (1 - si_weight) factor. The L2 terms
sum ||w||^2 / 2 over the conv kernels of a partition (the JAX trees' leaves
named `kernel`): here every conv weight of the partition's modules, the
masked 3-D convs' stored (unmasked) weight included, as the JAX package
regularizes its stored kernel. Biases, batch norm and siNet are not
regularized.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from dsin_tpu_torch.models.probclass import MaskedConv3d

_CONVS = (nn.Conv2d, nn.ConvTranspose2d, MaskedConv3d)


class RateLoss(NamedTuple):
    pc_loss: torch.Tensor
    H_real: torch.Tensor
    H_mask: torch.Tensor
    H_soft: torch.Tensor


def rate_loss(bitcost: torch.Tensor, heatmap: Optional[torch.Tensor],
              H_target: float, beta: float, batch=None) -> RateLoss:
    """`batch` (`parallel/data_parallel.BatchAxis`) takes the means over the
    global batch when the ranks of a data axis hold it in blocks: the hinge
    then sees the global H_soft, as the JAX package's global-batch step."""
    if batch is None:
        H_real = bitcost.mean()
        H_mask = (bitcost * heatmap).mean() if heatmap is not None else H_real
    elif heatmap is not None:
        H_real, H_mask = batch.means((bitcost, bitcost * heatmap))
    else:
        H_real = H_mask = batch.mean(bitcost)
    H_soft = 0.5 * (H_mask + H_real)
    pc_loss = beta * torch.clamp(H_soft - H_target, min=0.0)
    return RateLoss(pc_loss=pc_loss, H_real=H_real, H_mask=H_mask,
                    H_soft=H_soft)


def l2_of_kernels(module: nn.Module) -> torch.Tensor:
    """Sum of ||w||^2 / 2 over the conv kernels of `module`."""
    return sum(0.5 * torch.sum(torch.square(mod.weight.to(torch.float32)))
               for mod in module.modules() if isinstance(mod, _CONVS))


def regularization_losses(model, ae_config,
                          pc_config) -> Dict[str, torch.Tensor]:
    """L2 terms per partition of a DSIN: 'enc', 'dec', 'centers', 'pc'."""
    factor = ae_config.regularization_factor
    centers = model.centers.to(torch.float32)
    out = {"enc": factor * l2_of_kernels(model.encoder),
           "dec": factor * l2_of_kernels(model.decoder),
           "centers": (ae_config.regularization_factor_centers
                       * 0.5 * torch.sum(torch.square(centers)))}
    pc_factor = pc_config.regularization_factor
    out["pc"] = (pc_factor * l2_of_kernels(model.probclass)
                 if pc_factor is not None
                 else torch.zeros((), device=centers.device))
    return out


def total_loss(d_loss_scaled: torch.Tensor, rate: RateLoss,
               regs: Dict[str, torch.Tensor]) -> torch.Tensor:
    reg = regs["enc"] + regs["dec"] + regs["centers"] + regs["pc"]
    return d_loss_scaled + rate.pc_loss + reg


def si_l1_loss(x: torch.Tensor, x_with_si: torch.Tensor,
               batch=None) -> torch.Tensor:
    """Mean |x - x_with_si| (tf.losses.absolute_difference's default), over
    the global batch when `batch` is given (see `rate_loss`)."""
    if batch is None:
        return torch.abs(x - x_with_si).mean()
    return batch.mean(torch.abs(x - x_with_si))
