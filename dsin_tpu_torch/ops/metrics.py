"""Distortion metrics: MAE / MSE / PSNR with integer-cast semantics
(counterpart of the JAX package's `ops/metrics.py`).

Images are NHWC float32 in [0, 255]. When a metric is not the one being
optimized, or at evaluation, both operands are truncated to int32 first
(toward zero, as `astype(int32)` truncates; the inputs are in [0, 255], so
no NaN or out-of-range value reaches the cast), so the reported error is
that of real quantized pixels. Per-image means over (H, W, C), then a batch
mean, in float32, each computed as `jnp.mean` computes it (`mean`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

DISTORTIONS = ("mae", "mse", "psnr", "ms_ssim")


def mean(t: torch.Tensor, dims) -> torch.Tensor:
    """The mean over `dims` as the JAX package's `jnp.mean` computes it: the
    float32 sum times the float32 reciprocal of the count (XLA rewrites the
    division by a constant into that product, which can differ from the
    divided sum in the last bit). The int-cast metrics sum integers below
    2**24, exactly in any order, so they agree bit for bit."""
    count = 1
    for d in dims:
        count *= t.shape[d]
    inv = torch.tensor(1.0, dtype=torch.float32) / count
    return t.sum(dim=dims) * inv.to(t.device)


def _operands(x: torch.Tensor, x_out: torch.Tensor, cast_to_int: bool):
    if cast_to_int:
        return x.to(torch.int32), x_out.to(torch.int32)
    return x, x_out


def mae_per_image(x: torch.Tensor, x_out: torch.Tensor,
                  cast_to_int: bool) -> torch.Tensor:
    """Mean absolute error per image -> (N,)."""
    x, x_out = _operands(x, x_out, cast_to_int)
    return mean(torch.abs(x_out - x).to(torch.float32), (1, 2, 3))


def mse_per_image(x: torch.Tensor, x_out: torch.Tensor,
                  cast_to_int: bool) -> torch.Tensor:
    """Mean squared error per image -> (N,)."""
    x, x_out = _operands(x, x_out, cast_to_int)
    return mean(torch.square(x_out - x).to(torch.float32), (1, 2, 3))


def psnr_per_image(x: torch.Tensor, x_out: torch.Tensor,
                   cast_to_int: bool) -> torch.Tensor:
    """PSNR (dB, max_val 255) per image -> (N,)."""
    mse = mse_per_image(x, x_out, cast_to_int)
    return 10.0 * torch.log10(255.0 * 255.0 / mse)


class Distortions(NamedTuple):
    """Batch-mean distortions plus the scalar selected for minimization."""
    mae: torch.Tensor
    mse: torch.Tensor
    psnr: torch.Tensor
    ms_ssim: Optional[torch.Tensor]
    d_loss_scaled: torch.Tensor


def compute_distortions(config, x: torch.Tensor, x_out: torch.Tensor,
                        is_training: bool) -> Distortions:
    """All metrics + the distortion term to minimize. Each metric casts to
    int unless it is the one being trained on; at eval everything casts.
    MS-SSIM is computed only when it is the optimization target."""
    minimize_for = config.distortion_to_minimize
    if minimize_for not in DISTORTIONS:
        raise ValueError(f"distortion_to_minimize={minimize_for!r}: "
                         f"expected one of {DISTORTIONS}")
    cast_psnr = (not is_training) or minimize_for != "psnr"
    cast_mse = (not is_training) or minimize_for != "mse"
    cast_mae = (not is_training) or minimize_for != "mae"

    mae = mean(mae_per_image(x, x_out, cast_mae), (0,))
    mse = mean(mse_per_image(x, x_out, cast_mse), (0,))
    psnr = mean(psnr_per_image(x, x_out, cast_psnr), (0,))

    ms_ssim = None
    if minimize_for == "ms_ssim":
        from dsin_tpu_torch.ops.msssim import multiscale_ssim
        ms_ssim = multiscale_ssim(x, x_out)

    if minimize_for == "mae":
        d = mae
    elif minimize_for == "mse":
        d = mse
    elif minimize_for == "psnr":
        d = config.K_psnr - psnr
    else:
        d = config.K_ms_ssim * (1.0 - ms_ssim)
    return Distortions(mae=mae, mse=mse, psnr=psnr, ms_ssim=ms_ssim,
                       d_loss_scaled=d)
