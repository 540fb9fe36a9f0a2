"""Model and codec construction for the codec's entry points (counterpart of
the JAX package's `coding/loader.py:28-182`).

`load_model_state` builds the port's DSIN from its own seeded init
(`models/dsin.build_model`), restores a checkpoint's partitions over it when
given one (`train/checkpoint.py`, the JAX package's `.msgpack` format, the
manifest verified), and casts it to a rung of the precision ladder
(`coding/precision.py`); `make_codec` is the one `BottleneckCodec`
construction the call sites share; `params_digest` is the JAX package's
parameter digest; `encode_batch_isolated` and `decode_batch_isolated`
(the JAX package's `coding/loader.py:318, :373`) keep one lane's coding
error on that lane, for the service's entropy stage. The port's modules are fully convolutional and eager, so
no image shape is needed to build them.
"""

from __future__ import annotations

import hashlib
import warnings
from typing import Optional

import numpy as np
import torch

from dsin_tpu_torch import bridge
from dsin_tpu_torch.coding import precision as precision_lib
from dsin_tpu_torch.coding.codec import BottleneckCodec
from dsin_tpu_torch.config import parse_config_file
from dsin_tpu_torch.models.dsin import DSIN, build_model
from dsin_tpu_torch.train import checkpoint as ckpt_lib


def build_at_rung(ae_config, pc_config, device="cuda", seed: int = 0,
                  precision: str = "fp32",
                  ckpt_dir: Optional[str] = None) -> DSIN:
    """The seeded DSIN of two parsed configs on `device`, cast to the ladder
    rung `precision`. With `ckpt_dir` the AE partitions (+ siNet when the
    config builds it) are restored over the seeded weights and verified
    against the checkpoint's manifest (typed `ManifestMismatch`; a
    pre-manifest checkpoint loads with a UserWarning). At a rung other than
    fp32 the AE config's `compute_dtype` follows the rung; the float32
    weights are built and restored first, cast afterwards (identity is
    checked against the checkpoint's own bytes), and the entropy-critical
    tripwire runs last."""
    policy = precision_lib.PrecisionPolicy(precision)
    if policy.rung != "fp32":
        ae_config = ae_config.replace(compute_dtype=policy.compute_dtype)
    model = build_model(ae_config, pc_config, device=device, seed=seed)
    if ckpt_dir:
        restore_checkpoint(model, ckpt_dir)
    if policy.rung != "fp32":
        policy.cast_model(model)
        precision_lib.check_entropy_critical(model)
    return model


def restore_checkpoint(model: DSIN, ckpt_dir: str) -> dict:
    """Restore `AE_PARTITIONS` (+ 'sinet' iff the model has siNet) and the
    batch statistics from `ckpt_dir` into the float32 `model`, verified
    against the manifest as the JAX loader verifies it. Returns the
    verification record."""
    parts = list(ckpt_lib.AE_PARTITIONS)
    if model.sinet is not None:
        parts.append("sinet")
    state = ckpt_lib.restore_partitions(
        ckpt_dir, ckpt_lib.state_from_model(model), parts)
    info = ckpt_lib.verify_manifest(ckpt_dir, state, parts,
                                    pc_config=model.pc_config)
    if info["status"] == "legacy":
        warnings.warn(
            f"checkpoint {ckpt_dir} predates manifest.json — loaded "
            f"WITHOUT identity verification (re-save it to gain "
            f"digest/pc-hash checks and hot-swap eligibility)",
            stacklevel=3)
    ckpt_lib.load_state(model, state)
    return info


def load_model_state(ae_config_path: str, pc_config_path: str,
                     ckpt_dir: Optional[str] = None,
                     need_sinet: bool = False, seed: int = 0,
                     device="cuda", precision: str = "fp32") -> DSIN:
    """The DSIN model of the two config files on `device` (the card by
    default; raises without one) on the ladder rung `precision`: its
    weights from the checkpoint `ckpt_dir` (AE partitions, + siNet iff
    `need_sinet`), or from `seed` without one. siNet is built iff
    `need_sinet`, whatever the config's `AE_only` says; probclass and
    centers are float32 at every rung."""
    ae_cfg = parse_config_file(ae_config_path).replace(
        AE_only=not need_sinet)
    pc_cfg = parse_config_file(pc_config_path)
    return build_at_rung(ae_cfg, pc_cfg, device=device, seed=seed,
                         precision=precision, ckpt_dir=ckpt_dir)


def make_codec(model: DSIN) -> BottleneckCodec:
    """The one BottleneckCodec construction every call site shares."""
    return BottleneckCodec.for_model(model)


def treedef_repr(tree) -> str:
    """JAX's `repr(treedef)` of a tree of dicts, tuples, lists and None with
    array leaves: 'PyTreeDef({'a': *, 'b': (*, *)})', dict keys sorted as
    `jax.tree_util.tree_flatten` sorts them."""
    def node(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = ", ".join(node(v) for v in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        return "None" if t is None else "*"
    return f"PyTreeDef({node(tree)})"


def tree_leaves(tree) -> list:
    """The leaves in `jax.tree_util.tree_flatten`'s order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def _leaf_fields(leaf):
    """(dtype text, shape text, bytes) of a leaf as numpy states them; a
    bfloat16 tensor as ml_dtypes' bfloat16 array would."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", str(tuple(t.shape)), \
                t.view(torch.int16).numpy().tobytes()
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return str(arr.dtype), str(arr.shape), arr.tobytes()


def params_digest(tree, rung: str = "fp32") -> str:
    """The JAX package's order-stable parameter digest (v2): sha256 over the
    length-prefixed fields tag, rung, `repr(treedef)` and per leaf (dtype,
    shape, bytes); the first 16 hex digits. `tree` is the JAX layout
    (`train/checkpoint.ModelState` trees), not the port's state_dict."""
    h = hashlib.sha256()

    def _field(data: bytes) -> None:
        h.update(len(data).to_bytes(8, "little"))
        h.update(data)

    _field(b"dsin-params-digest-v2")
    _field(str(rung).encode())
    _field(treedef_repr(tree).encode())
    for leaf in tree_leaves(tree):
        for text_or_bytes in _leaf_fields(leaf):
            _field(text_or_bytes if isinstance(text_or_bytes, bytes)
                   else text_or_bytes.encode())
    return h.hexdigest()[:16]


def served_digest(model: DSIN, rung: str = "fp32") -> str:
    """`params_digest` of a served model: its weights in the JAX layout and
    in the dtypes they serve in, so a bf16 or int8 rung hashes its bfloat16
    leaves as bfloat16, as the JAX service hashes them."""
    return params_digest(bridge.jax_from_state_dict(model.state_dict(),
                                                    keep_bfloat16=True),
                         rung=rung)


def encode_batch_isolated(codec: BottleneckCodec, volumes) -> list:
    """Encode N (D, H, W) symbol volumes -> [(payload, None) |
    (None, exception)] per lane, via the one-native-call batch path,
    retrying lane by lane ONLY if the batch call refuses the set (a
    pathological lane, a scratch allocation failure): one lane's coding
    error must fail only ITS request, never its batchmates."""
    try:
        return [(p, None) for p in codec.encode_batch(list(volumes))]
    except Exception:
        out = []
        for vol in volumes:
            try:
                out.append((codec.encode(vol), None))
            except Exception as exc:  # noqa: BLE001 — per-lane isolation
                out.append((None, exc))
        return out


def decode_batch_isolated(codec: BottleneckCodec, payloads) -> list:
    """Decode N DTPC payloads -> [(volume, None) | (None, exception)] per
    lane, via `decode_batch`, retrying lane by lane ONLY if the batch
    refuses the set (header or structure errors): the decode half of the
    per-lane isolation contract."""
    try:
        return [(vol, None) for vol in codec.decode_batch(list(payloads))]
    except Exception:
        out = []
        for blob in payloads:
            try:
                out.append((codec.decode(blob), None))
            except Exception as exc:  # noqa: BLE001 — per-lane isolation
                out.append((None, exc))
        return out
