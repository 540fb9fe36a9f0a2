"""The forward of DSIN with its losses and metrics, and the train step
(counterpart of the JAX package's `train/step.py`: `_forward_losses`,
`build_train_step_fn` / `make_train_step`, `make_eval_step` and
`make_inference_step`).

encode -> decode, the side image's inference-mode encode and decode, the
patch search under the position prior, siNet, the distortions with the
train cast rules (the reference reuses the training distortion at eval),
the bitcost -> bpp and the rate and regularization losses:
`loss = total + si_weight * L1(x, x_with_si)`, divided by the configured
batch size when the SI path trains a batch larger than one.

The train branch (`train=True`) normalizes the encoder and decoder by batch
statistics (the side image keeps the running ones), runs the search with no
gradient on the detached decoded images (the search kernel has no backward
and needs none) and feeds the bitcost the detached bottleneck, so the rate
reaches the encoder only through the heatmap; the padding of the bitcost's
volume keeps its gradient to centers[0]. `make_train_step` takes one
optimizer step over the batch, or over `grad_accum` strided micro-batches
whose gradients and metrics it averages, their batch statistics chained.

The steps of more than one rank (`parallel/data_parallel.py`) come through
two hooks, as the JAX package's `synthesize_fn`: `synthesize_fn` replaces
the patch search (the width-sharded search), and `batch` (a
`BatchAxis`) takes every batch mean and sum of the loss, the metrics and
the train-mode batch norms over the global batch that the ranks of a data
axis hold in blocks, and averages the gradients over it before the update.

The prior is checked once per step built (`ops/sifinder.check_mask`), not
per image: the check of a 320x1224 Gaussian prior reads its 1.18 GB. A mask
that checks as the standard Gaussian prior is kept as its factors only, and
the prior of `ops/sifinder.standard_prior` is never built at all, so at
1024x2048 (33.3 GB with 16x32 patches) no (Hc, Wc, P) prior reaches the
card.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from dsin_tpu_torch.models.autoencoder import apply_batch_stats
from dsin_tpu_torch.models.probclass import bitcost_to_bpp
from dsin_tpu_torch.ops import metrics as metrics_lib
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.train import losses as loss_lib

SCALAR_METRICS = ("bpp", "H_real", "H_soft", "pc_loss", "d_loss", "mae",
                  "psnr", "si_l1")


def forward_losses(model, x: torch.Tensor, y: torch.Tensor, si_mask,
                   train: bool = False, bn_stats: Optional[dict] = None,
                   on_search: Optional[Callable[[str], None]] = None,
                   synthesize_fn: Optional[Callable] = None, batch=None):
    """The shared forward: (loss, aux dict), for NHWC float32 batches in
    [0, 255] on the model's device. `si_mask` is None, an (Hc, Wc, P) prior
    or a `CheckedMask`. `bn_stats`, in training only, receives the batch
    statistics of the encoder's and decoder's batch norms
    (`autoencoder.batch_norm`). `on_search(name)`, when given, is called
    with 'search_start' and 'search' just before and after the patch search
    (a measurement hook). `synthesize_fn(x_dec, y, y_dec) -> y_syn`, when
    given, replaces the search (`si_mask` is then unused); `batch` takes
    the batch reductions over the ranks of a data axis (module
    docstring)."""
    if bn_stats is not None and not train:
        raise ValueError("bn_stats records batch statistics, which only "
                         "the train branch computes")
    cfg = model.ae_config
    enc = model.encode(x, train, bn_stats, batch)
    x_dec = model.decode(enc.qbar, train, bn_stats, batch)
    if model.ae_only:
        x_with_si = torch.zeros_like(x)
        y_syn = None
        si_l1 = torch.zeros((), device=x.device)
        si_weight = 0.0
    else:
        ph, pw = (int(v) for v in cfg.y_patch_size)
        with torch.no_grad():
            y_dec = model.decode(model.encode(y).qbar)
            if on_search is not None:
                on_search("search_start")
            if synthesize_fn is not None:
                y_syn = synthesize_fn(x_dec.detach(), y, y_dec)
            else:
                y_syn = sifinder_lib.synthesize_side_image(
                    x_dec.detach(), y, y_dec, si_mask, ph, pw, cfg)
            if on_search is not None:
                on_search("search")
        x_with_si = model.apply_sinet(x_dec, y_syn)
        si_l1 = loss_lib.si_l1_loss(x, x_with_si, batch)
        si_weight = cfg.si_weight

    # the train cast rules even at eval, as the reference's eval loss
    dist = metrics_lib.compute_distortions(cfg, x, x_dec, is_training=True,
                                           batch=batch)
    d_scaled = (1.0 - si_weight) * dist.d_loss_scaled
    bc = model.bitcost(enc.qbar.detach() if train else enc.qbar, enc.symbols)
    bpp = bitcost_to_bpp(bc, x, batch)
    rate = loss_lib.rate_loss(bc, enc.heatmap, cfg.H_target, cfg.beta, batch)
    regs = loss_lib.regularization_losses(model, cfg, model.pc_config)
    total = loss_lib.total_loss(d_scaled, rate, regs)
    loss = total + si_weight * si_l1
    if train and not model.ae_only and cfg.batch_size > 1:
        loss = loss / float(cfg.batch_size)
    aux = {"symbols": enc.symbols, "bpp": bpp, "H_real": rate.H_real,
           "H_soft": rate.H_soft, "pc_loss": rate.pc_loss,
           "d_loss": dist.d_loss_scaled, "mae": dist.mae, "psnr": dist.psnr,
           "si_l1": si_l1, "x_dec": x_dec, "x_with_si": x_with_si,
           "y_syn": y_syn}
    return loss, aux


def _scalar_metrics(loss, aux) -> Dict[str, torch.Tensor]:
    metrics = {k: aux[k].detach() for k in SCALAR_METRICS}
    metrics["loss"] = loss.detach()
    return metrics


def _checked(model, si_mask):
    """The prior checked once, where it lies: the standard Gaussian prior
    is kept as its factors only, any other mask goes to the model's
    device."""
    if si_mask is None or isinstance(si_mask, sifinder_lib.CheckedMask):
        return si_mask
    ph, pw = (int(v) for v in model.ae_config.y_patch_size)
    checked = sifinder_lib.check_mask(si_mask, ph, pw)
    if checked.factors is not None:
        return checked._replace(mask=None)
    return checked._replace(mask=checked.mask.to(model.centers.device))


def _as_batch(model, t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32,
                           device=model.centers.device)


class TrainState(NamedTuple):
    """The live training state: the model holds the parameters and batch
    statistics, the optimizer (`train/optim.Optimizer`) its state and the
    step."""
    model: torch.nn.Module
    optimizer: object

    @property
    def step(self) -> int:
        return self.optimizer.step


def make_train_step(model, optimizer, si_mask=None, grad_accum: int = 1,
                    on_phase: Optional[Callable[[str], None]] = None,
                    on_search: Optional[Callable[[str], None]] = None,
                    synthesize_fn: Optional[Callable] = None, batch=None):
    """(x, y) -> (TrainState, metrics): one optimizer step on the batch,
    the model and optimizer updated in place, the scalar metrics
    (`SCALAR_METRICS` and 'loss') as detached tensors on the device, read
    by the caller when it needs them. `grad_accum > 1` splits the batch
    into that many strided micro-batches (micro k = rows k::grad_accum),
    each with its own batch statistics chained into the next, and averages
    their gradients and metrics before the one update. With
    `bn_stats = 'frozen'` the running statistics are not updated.
    `on_phase(name)`, when given, is called after 'forward', 'backward' and
    'optimizer', and `on_search` around the search (`forward_losses`):
    measurement hooks. `synthesize_fn` and `batch`: the hooks of the steps
    over more than one rank (module docstring); with `batch` the batch is
    this rank's rows, micro k is its rows k::grad_accum (the JAX package's
    strided micro of the global batch, whose rows the data axis holds in
    blocks of a multiple of grad_accum), and the averaged gradients are
    averaged over the data axis before the update."""
    mask = _checked(model, si_mask)
    update_bn = model.ae_config.get("bn_stats", "update") == "update"
    params = optimizer.params
    state = TrainState(model, optimizer)
    mark = on_phase or (lambda name: None)

    def micro_step(x, y) -> Dict[str, torch.Tensor]:
        stats = {} if update_bn else None
        loss, aux = forward_losses(model, x, y, mask, train=True,
                                   bn_stats=stats, on_search=on_search,
                                   synthesize_fn=synthesize_fn, batch=batch)
        mark("forward")
        loss.backward()
        if stats:
            apply_batch_stats(stats)
        mark("backward")
        return _scalar_metrics(loss, aux)

    def train_step(x, y):
        x, y = _as_batch(model, x), _as_batch(model, y)
        for p in params.values():
            p.grad = None
        if grad_accum == 1:
            metrics = micro_step(x, y)
        else:
            if x.shape[0] % grad_accum:
                raise ValueError(f"batch {x.shape[0]} not divisible by "
                                 f"grad_accum {grad_accum}")
            metrics = None
            for k in range(grad_accum):
                m = micro_step(x[k::grad_accum].contiguous(),
                               y[k::grad_accum].contiguous())
                metrics = m if metrics is None else {
                    name: metrics[name] + m[name] for name in metrics}
            inv = 1.0 / grad_accum
            with torch.no_grad():
                for p in params.values():
                    if p.grad is not None:
                        p.grad.mul_(inv)
            metrics = {k: v * inv for k, v in metrics.items()}
        if batch is not None:
            batch.average_grads(params.values())
        optimizer.update({n: p.grad for n, p in params.items()})
        mark("optimizer")
        return state, metrics

    return train_step


def make_eval_step(model, si_mask: Optional[torch.Tensor] = None,
                   synthesize_fn: Optional[Callable] = None, batch=None):
    """(x, y) -> the scalar metrics (`SCALAR_METRICS` and 'loss');
    `synthesize_fn` and `batch` as for `make_train_step`."""
    mask = _checked(model, si_mask)

    @torch.inference_mode()
    def eval_step(x, y) -> Dict[str, torch.Tensor]:
        loss, aux = forward_losses(model, _as_batch(model, x),
                                   _as_batch(model, y), mask,
                                   synthesize_fn=synthesize_fn, batch=batch)
        return _scalar_metrics(loss, aux)

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
