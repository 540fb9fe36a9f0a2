"""Weights of the JAX package <-> the port's `state_dict`.

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

`jax_from_state_dict` is the inverse: the port's state_dict -> the JAX
`params` / `batch_stats` trees (numpy, flax's module names, the kernels back
in HWIO / DHWIO with the transposed convs flipped back), and
`state_dict_from_jax(*jax_from_state_dict(sd))` equals `sd`. An optimizer's
moments take exactly the layout transform of their parameter
(`jax_params_tree`, `named_from_jax_tree`): Adam and momentum are
elementwise, so the carry is exact. The `.msgpack` checkpoint files
themselves are read and written by `train/checkpoint.py`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

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


_INVERSE_SEGMENTS = {"res": "_ResGroupStack_0", "bn": "BatchNorm_0"}
_CONV_SEGMENT = re.compile(r"^conv(\d+)$")
# the decoder's three upsampling ConvBNs are the transposed convs
_TRANSPOSED = re.compile(r"^decoder\.conv\d+\.conv\.weight$")
_BN_INVERSE = {v: k for k, v in _BN_LEAVES.items()}


def _jax_path(key: str):
    """'decoder.res.blocks.3.conv0.conv.weight' -> the flax module path and
    the leaf's torch name ('weight')."""
    parts = key.split(".")
    partition, names, leaf = parts[0], parts[1:-1], parts[-1]
    path, i = [partition], 0
    while i < len(names):
        name = names[i]
        match = _CONV_SEGMENT.match(name)
        if name == "blocks":
            path.append(f"_ResBlock_{names[i + 1]}")
            i += 1
        elif match and partition == "probclass":
            path.append(f"_MaskedConv3D_{match.group(1)}")
        elif match and partition in ("encoder", "decoder"):
            path.append(f"_ConvBN_{match.group(1)}")
        elif name == "conv":
            path.append("ConvTranspose_0" if _TRANSPOSED.match(key)
                        else "Conv_0")
        else:
            path.append(_INVERSE_SEGMENTS.get(name, name))
        i += 1
    return path, leaf


def _jax_kernel(key: str, value: np.ndarray) -> np.ndarray:
    if _TRANSPOSED.match(key):
        return value.transpose(2, 3, 0, 1)[::-1, ::-1]
    if value.ndim == 5:
        return value.transpose(2, 3, 4, 1, 0)
    if value.ndim == 4:
        return value.transpose(2, 3, 1, 0)
    raise ValueError(f"unexpected weight rank {value.ndim} at {key}")


def _put(tree: Dict[str, Any], path, value) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


def _jax_leaf(key: str):
    """A state_dict key -> (its flax path, whether it is a batch
    statistic)."""
    if key == "centers":
        return ["centers"], False
    path, leaf = _jax_path(key)
    if path[-1] == "BatchNorm_0":
        name = _BN_INVERSE[leaf]
        return path + [name], name in ("mean", "var")
    if leaf in ("weight", "bias"):
        return path + ["kernel" if leaf == "weight" else "bias"], False
    raise KeyError(f"unmapped state_dict entry {key}")


def _jax_value(key: str, tensor: torch.Tensor, keep_bfloat16: bool = False):
    """A state_dict value -> a C-contiguous float32 array in the JAX
    layout, a copy (never a view of a CPU tensor that later changes). With
    `keep_bfloat16`, a bfloat16 tensor stays bfloat16: its bits take the
    same layout transform and come back as a CPU bfloat16 tensor (numpy has
    no bfloat16)."""
    tensor = tensor.detach().cpu()
    bits = keep_bfloat16 and tensor.dtype == torch.bfloat16
    value = (tensor.view(torch.int16) if bits else tensor.float()).numpy()
    if key != "centers" and key.endswith(".weight") \
            and ".bn." not in key:
        value = _jax_kernel(key, value)
    value = np.array(value, order="C", copy=True)
    return torch.from_numpy(value).view(torch.bfloat16) if bits else value


def jax_from_state_dict(state_dict: Dict[str, torch.Tensor],
                        keep_bfloat16: bool = False):
    """The port's state_dict -> (params, batch_stats): the JAX package's
    trees as C-contiguous float32 numpy arrays, what its checkpoints hold.
    `num_batches_tracked` has no JAX counterpart and is dropped. With
    `keep_bfloat16`, the leaves a precision rung cast to bfloat16 stay
    bfloat16 (tensors), as the JAX package serves them: the tree that
    `coding/loader.params_digest` hashes for a served model."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        path, is_stat = _jax_leaf(key)
        _put(batch_stats if is_stat else params, path,
             _jax_value(key, tensor, keep_bfloat16))
    return params, batch_stats


def jax_params_tree(named: Dict[str, Optional[torch.Tensor]]):
    """Per-parameter tensors keyed by the port's parameter names (an
    optimizer's moments) -> one tree in the JAX params layout, each tensor
    transformed as its parameter is (HWIO kernels, transposed convs
    flipped back); a None value becomes an empty map, as flax writes an
    optax leaf that a group's mask leaves out."""
    tree: Dict[str, Any] = {}
    for key, tensor in named.items():
        path, _ = _jax_leaf(key)
        _put(tree, path, {} if tensor is None else _jax_value(key, tensor))
    return tree


def named_from_jax_tree(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The inverse of `jax_params_tree`: the arrays of a JAX params-layout
    tree keyed by the port's parameter names, in the port's layout; empty
    maps are left out."""
    return state_dict_from_jax(tree, {})


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
