"""Optimizers: per-subsystem learning rates over one model (counterpart of
the JAX package's `train/optim.py`).

Every parameter carries a label from its top-level partition: 'pc' for the
probclass (its own optimizer and schedule), 'ae' for the encoder, decoder,
centers and siNet, 'centers' for the quantizer centers when
`lr_centers_factor` is set (the AE optimizer at that multiple of the AE
rate), and 'frozen' for a partition that `train_autoencoder = False` or
`train_probclass = False` switches off (freezing the AE freezes the centers
too). Each group keeps its own state, as optax's `multi_transform` does.

ADAM, SGD and MOMENTUM (Nesterov) are written by hand in optax's arithmetic
order, in float32, so a step equals optax's on the same gradients up to the
rounding of the device's kernels:
  ADAM      mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g*g + b2 nu;  count += 1;
            u = (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count)) + eps)
  MOMENTUM  t = g + m t;  u = g + m t
  SGD       u = g
  then p = p + (-lr(count before the step)) * u.
(`torch.optim.Adam` rounds in another order.) The schedules and the bias
corrections are computed on the host in float32, as optax computes them.

`Optimizer.state_tree()` is the optimizer state in the layout flax writes
for optax's state (`opt_state.msgpack` of a checkpoint), and
`load_state_tree` reads it back; `bridge.py` carries each moment in the
layout of its parameter.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dsin_tpu_torch import bridge

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
INT32_MAX = 2 ** 31 - 1


def iterations_per_epoch(num_crops_per_img: int, batch_size: int,
                         num_training_imgs: int, ae_only: bool) -> int:
    """Steps per epoch, with the hardcoded 1,281,000-image "ImageNet epoch"
    of an AE-only run."""
    num_unique_imgs_per_batch = max(batch_size // num_crops_per_img, 1)
    if ae_only:
        num_training_imgs = 1281000
    return max(num_training_imgs // num_unique_imgs_per_batch, 1)


def learning_rate_schedule(config, num_crops_per_img: int,
                           num_training_imgs: int, batch_size: int,
                           ae_only: bool) -> Callable[[int], float]:
    """count -> learning rate: FIXED (the config's float) or (staircase)
    exponential DECAY over an epoch-based interval, in float32 as
    `optax.exponential_decay` computes it."""
    lr = config.lr_initial
    if config.lr_schedule == "FIXED":
        return lambda count: lr
    if config.lr_schedule != "DECAY":
        raise ValueError(f"invalid lr_schedule {config.lr_schedule!r}")
    steps = (iterations_per_epoch(num_crops_per_img, batch_size,
                                  num_training_imgs, ae_only)
             * config.lr_schedule_decay_interval)
    rate = config.lr_schedule_decay_rate
    staircase = config.lr_schedule_decay_staircase
    if steps <= 0 or rate == 0:
        return lambda count: lr

    def schedule(count: int):
        p = np.float32(count) / np.float32(steps)
        if staircase:
            p = np.floor(p)
        if count <= 0:
            return np.float32(lr)
        return np.float32(lr) * np.power(np.float32(rate), p)

    return schedule


def _scaled(schedule: Callable[[int], float], factor: float):
    """`schedule(count) * factor` with optax's promotion: a float32 value
    times a Python float stays float32; two Python floats multiply in
    double."""
    def scaled(count: int):
        value = schedule(count)
        if isinstance(value, np.floating):
            return value * np.float32(factor)
        return value * factor
    return scaled


def label_for(part: str, ae_config) -> str:
    """The optimizer group of a top-level partition."""
    if part == "probclass":
        return "pc" if ae_config.get("train_probclass", True) else "frozen"
    if part in ("encoder", "decoder", "centers"):
        if not ae_config.get("train_autoencoder", True):
            return "frozen"
        if part == "centers" and ae_config.get("lr_centers_factor") \
                is not None:
            return "centers"
    return "ae"


class _Group:
    """One optimizer over the parameters `names`: its kind ('ADAM', 'SGD',
    'MOMENTUM' or 'frozen'), schedule, step count and moment tensors."""

    def __init__(self, kind: str, schedule, momentum: Optional[float],
                 names: List[str], params: Dict[str, torch.Tensor]):
        if kind not in ("ADAM", "SGD", "MOMENTUM", "frozen"):
            raise ValueError(f"invalid optimizer {kind!r}")
        self.kind, self.schedule, self.momentum = kind, schedule, momentum
        self.names = names
        self.count = 0
        slots = {"ADAM": ("mu", "nu"), "MOMENTUM": ("trace",)}.get(kind, ())
        self.slots = {s: {n: torch.zeros_like(params[n]) for n in names}
                      for s in slots}

    def update(self, params: List[torch.Tensor],
               grads: List[torch.Tensor]) -> None:
        if self.kind == "frozen":      # optax's set_to_zero keeps no count
            return
        count = self.count
        self.count = min(count + 1, INT32_MAX)
        if not params:
            return
        if self.kind == "ADAM":
            mu = list(self.slots["mu"].values())
            nu = list(self.slots["nu"].values())
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - ADAM_B1))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1 - ADAM_B2)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_add_(nu, sq)
            dev = params[0].device
            # 1 - b**count in float32; divided as tensors, since a CUDA
            # division by a host scalar multiplies by its reciprocal
            bc1, bc2 = (torch.full((), float(np.float32(1) - np.float32(b)
                                             ** np.float32(self.count)),
                                   device=dev)
                        for b in (ADAM_B1, ADAM_B2))
            mu_hat = [m / bc1 for m in mu]
            den = torch._foreach_sqrt([v / bc2 for v in nu])
            torch._foreach_add_(den, ADAM_EPS)
            updates = torch._foreach_div(mu_hat, den)
        elif self.kind == "MOMENTUM":
            trace = list(self.slots["trace"].values())
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            updates = torch._foreach_mul(trace, self.momentum)
            torch._foreach_add_(updates, grads)
        else:
            updates = grads
        step_size = -1 * self.schedule(count)
        torch._foreach_add_(params, torch._foreach_mul(updates,
                                                       float(step_size)))

    def state_tree(self, all_names: List[str]) -> dict:
        """This group's `inner_state` in flax's layout of optax's state."""
        if self.kind == "frozen":
            return {}
        count = np.asarray(self.count, np.int32)
        first = {s: bridge.jax_params_tree({
            n: slot.get(n) for n in all_names}) for s, slot in
            self.slots.items()}
        if self.kind == "ADAM":
            first["count"] = count
        return {"0": first, "1": {"count": np.asarray(self.count, np.int32)}}

    @torch.no_grad()
    def load_state_tree(self, tree: dict, what: str) -> None:
        if self.kind == "frozen":
            return
        counts = [int(np.asarray(tree["1"]["count"]))]
        if self.kind == "ADAM":
            counts.append(int(np.asarray(tree["0"]["count"])))
        if len(set(counts)) != 1:
            raise ValueError(f"{what}: the step counts of one group differ: "
                             f"{counts}")
        for s, slot in self.slots.items():
            loaded = bridge.named_from_jax_tree(tree["0"][s])
            if set(loaded) != set(slot):
                raise ValueError(
                    f"{what}/{s}: the checkpoint holds moments of "
                    f"{sorted(set(loaded) ^ set(slot))[:4]} where the model "
                    f"does not, or lacks them")
            for name, value in loaded.items():
                slot[name].copy_(value)
        self.count = counts[0]


class Optimizer:
    """The two-group optimizer of a DSIN: `update(grads)` applies one step
    to the model's parameters in place; `step` counts the updates."""

    def __init__(self, model, ae_config, pc_config, num_training_imgs: int):
        self.params = dict(model.named_parameters())
        self.names = list(self.params)
        batch, crops = ae_config.batch_size, ae_config.num_crops_per_img
        ae_only = bool(ae_config.AE_only)
        ae_sched = learning_rate_schedule(ae_config, crops, num_training_imgs,
                                          batch, ae_only)
        pc_sched = learning_rate_schedule(pc_config, crops, num_training_imgs,
                                          batch, ae_only)
        self.labels = {n: label_for(n.split(".")[0], ae_config)
                       for n in self.names}
        spec = {"ae": (ae_config.optimizer, ae_sched, ae_config),
                "pc": (pc_config.optimizer, pc_sched, pc_config),
                "frozen": ("frozen", None, None)}
        factor = ae_config.get("lr_centers_factor")
        if factor is not None:
            spec["centers"] = (ae_config.optimizer,
                               _scaled(ae_sched, factor), ae_config)
        self.groups = {
            label: _Group(kind, sched,
                          cfg.get("optimizer_momentum") if cfg else None,
                          [n for n in self.names if self.labels[n] == label],
                          self.params)
            for label, (kind, sched, cfg) in spec.items()}
        self.step = 0

    @torch.no_grad()
    def update(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """One step on `grads` (by parameter name; None counts as zeros)."""
        for group in self.groups.values():
            group.update(
                [self.params[n] for n in group.names],
                [grads[n] if grads[n] is not None
                 else torch.zeros_like(self.params[n]) for n in group.names])
        self.step += 1

    def state_tree(self) -> dict:
        """The optimizer state as flax writes optax's `multi_transform`
        state: {'inner_states': {label: {'inner_state': ...}}}, numpy
        leaves, the moments in the JAX package's parameter layout and an
        empty map for each parameter outside the group."""
        return {"inner_states": {
            label: {"inner_state": group.state_tree(self.names)}
            for label, group in self.groups.items()}}

    def load_state_tree(self, tree: dict) -> None:
        """Load a state written by `state_tree` or by the JAX package
        (its structure checked by the caller against `state_tree()`)."""
        for label, group in self.groups.items():
            group.load_state_tree(tree["inner_states"][label]["inner_state"],
                                  f"opt_state/{label}")
