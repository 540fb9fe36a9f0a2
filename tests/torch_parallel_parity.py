"""Shared by the port's parallel train-step tests: one step of the JAX
package's sharded or width-sharded step from the port's seeded weights,
and the port's ranks' results in the JAX layout, for the bounds of
`tests/torch_train_parity.py`."""

import threading

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dsin_tpu.config import parse_config as jax_parse_config
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu.train import optim as jax_optim
from dsin_tpu.train import step as jax_step
from dsin_tpu_torch import bridge
from dsin_tpu_torch.models.dsin import build_model
from torch_train_parity import grads_from_first_moment


def jax_sharded_step(ae, pc, x, y, seed, build):
    """One step of `build(jax_model, tx)` (one of the JAX package's step
    constructors) from the port's seeded weights: {metrics, grads (read
    from Adam's first moment), params, batch_stats, old (the params
    before), step}."""
    model = build_model(ae, pc, device="cpu", seed=seed)
    params, stats = bridge.jax_from_state_dict(model.state_dict())
    jm = JaxDSIN(jax_parse_config(str(ae)), jax_parse_config(str(pc)))
    tx = jax_optim.build_optimizer(params, jm.ae_config, jm.pc_config, 10)
    state = jax_step.TrainState(params=params, batch_stats=stats,
                                opt_state=tx.init(params),
                                step=jnp.int32(0))
    new, metrics = jax.device_get(build(jm, tx)(state, jnp.asarray(x),
                                                jnp.asarray(y)))
    opt_state = flax.serialization.to_state_dict(new.opt_state)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads_from_first_moment(opt_state),
            "params": new.params, "batch_stats": new.batch_stats,
            "old": params, "step": int(new.step)}


def port_result(rank: dict) -> dict:
    """A rank's `torch_parallel_ranks.train_cases` entry in the JAX
    layout."""
    params, stats = bridge.jax_from_state_dict(
        {k: torch.from_numpy(v) for k, v in rank["state"].items()})
    return {"metrics": rank["metrics"], "params": params,
            "batch_stats": stats, "step": rank["step"],
            "grads": bridge.jax_params_tree(
                {n: torch.from_numpy(g) for n, g in rank["grads"].items()})}


def states_equal(ranks: list) -> bool:
    """Every rank's parameters and statistics bit-equal to rank 0's."""
    first = ranks[0]["state"]
    return all(set(r["state"]) == set(first) and all(
        np.array_equal(r["state"][k], v) for k, v in first.items())
        for r in ranks)


class Background:
    """`fn(*args)` on a thread: the ranks run while the JAX side
    compiles."""

    def __init__(self, fn, *args):
        self._out = {}

        def target():
            try:
                self._out["value"] = fn(*args)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                self._out["error"] = e

        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()

    def result(self, timeout: float):
        self._thread.join(timeout)
        assert not self._thread.is_alive(), "the ranks did not finish"
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]
