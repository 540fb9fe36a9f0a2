"""Weights of the JAX package -> the port's `state_dict`.

Input: the flax `params` and `batch_stats` trees as nested dicts of numpy
arrays (for instance `jax.tree_util.tree_map(np.asarray, variables)`), with
the partitions `encoder`, `decoder`, `centers`, `probclass`, `sinet` and the
encoder/decoder batch statistics. Output: a `state_dict` that
`DSIN.load_state_dict(..., strict=True)` accepts.

Layout rules:
  * `nn.Conv` kernels HWIO -> OIHW;
  * `nn.ConvTranspose` kernels (kh, kw, I, O) -> spatially flipped
    (I, O, kh, kw), because the port runs the reference's unflipped
    dilated correlation as `conv_transpose2d` (models/autoencoder.py);
  * masked 3-D conv kernels DHWIO -> OIDHW (the mask stays a buffer,
    multiplied in at use);
  * batch norm scale/bias/mean/var -> weight/bias/running_mean/running_var.

Reading `.msgpack` checkpoints is not part of this module yet.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

_SEGMENT_RULES = (
    (re.compile(r"^_ConvBN_(\d+)$"), r"conv\1"),
    (re.compile(r"^_MaskedConv3D_(\d+)$"), r"conv\1"),
    (re.compile(r"^_ResGroupStack_0$"), "res"),
    (re.compile(r"^_ResBlock_(\d+)$"), r"blocks.\1"),
    (re.compile(r"^(Conv|ConvTranspose)_0$"), "conv"),
    (re.compile(r"^BatchNorm_0$"), "bn"),
)
_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _segment(name: str) -> str:
    for pattern, repl in _SEGMENT_RULES:
        if pattern.match(name):
            return pattern.sub(repl, name)
    return name          # sinet's g_conv{i} / g_conv_last keep their names


def _kernel(path, value: np.ndarray) -> np.ndarray:
    if "ConvTranspose_0" in path:
        return value[::-1, ::-1].transpose(2, 3, 0, 1)
    if value.ndim == 5:
        return value.transpose(4, 3, 0, 1, 2)
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    raise ValueError(f"unexpected kernel rank {value.ndim} at {'/'.join(path)}")


def _walk(tree: Dict[str, Any], path=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value)


def state_dict_from_jax(params: Dict[str, Any],
                        batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map the JAX `params` / `batch_stats` trees to the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _walk(params):
        leaf = path[-1]
        if path == ("centers",):
            key, arr = "centers", value
        elif leaf == "kernel":
            key, arr = ".".join(map(_segment, path[:-1])) + ".weight", \
                _kernel(path, value)
        elif path[-2] == "BatchNorm_0":
            key, arr = ".".join(map(_segment, path[:-1])) + "." + \
                _BN_LEAVES[leaf], value
        elif leaf == "bias":
            key, arr = ".".join(map(_segment, path)), value
        else:
            raise KeyError(f"unmapped parameter {'/'.join(path)}")
        out[key] = torch.tensor(np.ascontiguousarray(arr, np.float32))
    for path, value in _walk(batch_stats):
        prefix = ".".join(map(_segment, path[:-1]))
        out[prefix + "." + _BN_LEAVES[path[-1]]] = torch.tensor(
            np.ascontiguousarray(value, np.float32))
        out[prefix + ".num_batches_tracked"] = torch.tensor(0)
    return out
