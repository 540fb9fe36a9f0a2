"""Partitioned checkpoints in the JAX package's format (counterpart of its
`train/checkpoint.py`): the same files, manifest and messages, so a
checkpoint written by either package restores in the other.

A checkpoint directory holds one flax-msgpack file per parameter partition
(`params_{encoder,decoder,centers,probclass,sinet}.msgpack`, `centers` a
bare array), `batch_stats.msgpack`, with a training state `opt_state.msgpack` (the
optimizer state in flax's layout of optax's `multi_transform` state,
`train/optim.py`), `manifest.json` and `meta.json`, written through
`utils/flax_msgpack.py`. The trees are the JAX package's layout (HWIO
kernels, flax module names) as numpy arrays: a `ModelState`, which
`state_from_model` builds from the port's DSIN (and optimizer) through
`bridge.py` and `load_state` loads back. A state without an optimizer
writes no `opt_state.msgpack` (the manifest lists only the files written).

Durability as in the JAX package: `save_checkpoint` stages everything into
a fsynced `<dir>.tmp-<pid>` sibling, rotates the live dir aside to
`<dir>.prev-NNNNNN` and renames the staged dir into place, so a kill at any
point leaves a complete checkpoint that `latest_checkpoint` resolves; the
manifest is written before `meta.json`, the completeness marker. The fault
sites `ckpt.write` (each attempt of each staged file write) and `ckpt.swap`
(between the two renames) are where the JAX package has them, so one
`FaultPlan` kills a save of either package at the same point. Loaders
verify what they restored against the manifest (`verify_manifest`) and
refuse a mismatch with a typed `ManifestMismatch`. `replicate_checkpoint`
copies the resolved latest checkpoint to a peer-visible root, every byte
CRC-checked against the manifest on both sides of the copy.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Iterable, List, NamedTuple, Optional

from dsin_tpu_torch import bridge
from dsin_tpu_torch.utils import faults, flax_msgpack
from dsin_tpu_torch.utils.integrity import IntegrityError, frame_crc
from dsin_tpu_torch.utils.retry import RetryPolicy, call_with_retry

AE_PARTITIONS = ("encoder", "decoder", "centers", "probclass")

MANIFEST_NAME = "manifest.json"
#: loaders refuse a manifest from a future version
MANIFEST_VERSION = 1
#: bounded retry for transient write failures (the JAX package's
#: WRITE_RETRY); persistent failures propagate after the third attempt
WRITE_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.05,
                          max_delay_s=0.5)


class ManifestMismatch(ValueError):
    """A checkpoint's manifest disagrees with what a loader restored (wrong
    params bytes, different pc config, different bucket ladder, future
    format)."""


class ModelState(NamedTuple):
    """The JAX package's trees of one model: `params` {partition: tree},
    `batch_stats` {"encoder": ..., "decoder": ...}, numpy leaves in the
    JAX layout; `step` the optimizer step (0 without training);
    `opt_state` the optimizer's `state_tree()`, or None without one."""
    params: Dict[str, Any]
    batch_stats: Dict[str, Any]
    step: int = 0
    opt_state: Any = None


def state_from_model(model, step: int = 0, optimizer=None) -> ModelState:
    """The port's DSIN -> its JAX-layout trees (`bridge.jax_from_state_dict`);
    with an optimizer (`train/optim.Optimizer`), its state and step."""
    params, batch_stats = bridge.jax_from_state_dict(model.state_dict())
    if optimizer is None:
        return ModelState(params, batch_stats, step)
    return ModelState(params, batch_stats, optimizer.step,
                      optimizer.state_tree())


def load_state(model, state: ModelState, optimizer=None) -> None:
    """Load JAX-layout trees into the port's DSIN (strict); with an
    optimizer, also the state's step and, where the state holds one, its
    optimizer state."""
    model.load_state_dict(bridge.state_dict_from_jax(state.params,
                                                     state.batch_stats),
                          strict=True)
    if optimizer is not None:
        if state.opt_state is not None:
            optimizer.load_state_tree(state.opt_state)
        optimizer.step = int(state.step)


def _fsync_dir(path: str) -> None:
    """Flush a directory's entry table; best-effort where dirs can't be
    opened."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_bytes_durable(path: str, data: bytes) -> None:
    """write + flush + fsync, with a bounded retry on transient OSError.
    Each attempt revisits the `ckpt.write` fault site."""

    def _attempt():
        faults.inject("ckpt.write")
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    call_with_retry(_attempt, WRITE_RETRY, retry_on=(OSError,))


def _write_msgpack(path: str, tree) -> Dict[str, int]:
    data = flax_msgpack.serialize(tree)
    _write_bytes_durable(path, data)
    return {"bytes": len(data), "crc32": frame_crc(data)}


def _read_msgpack(path: str):
    with open(path, "rb") as f:
        return flax_msgpack.deserialize(f.read())


def _tree_digest(tree) -> str:
    """The one parameter digest (`coding/loader.py params_digest`)."""
    from dsin_tpu_torch.coding.loader import params_digest
    return params_digest(tree)


def config_sha256(config) -> str:
    """Canonical-text hash of a Config (str() round-trips through
    parse_config, so equal semantics hash equal)."""
    return hashlib.sha256(str(config).encode()).hexdigest()[:16]


def build_manifest(state: ModelState,
                   files: Optional[Dict[str, Dict[str, int]]] = None,
                   extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Format version, per-partition content digests, the whole-tree
    `params_digest`, per-file CRC32s, and the caller's identity (`extra`:
    the pc-config hash, the init seed, a bucket ladder)."""
    manifest: Dict[str, Any] = {
        "manifest_version": MANIFEST_VERSION,
        "step": int(state.step),
        "partitions": sorted(state.params.keys()),
        "partition_digests": {part: _tree_digest(sub)
                              for part, sub in state.params.items()},
        "batch_stats_digest": _tree_digest(state.batch_stats),
        "params_digest": _tree_digest((state.params, state.batch_stats)),
    }
    if files is not None:
        manifest["files"] = dict(sorted(files.items()))
    if extra:
        if "canary" in extra:
            # golden canary digests (serve/quality.py): a service refuses a
            # swap whose staged outputs do not match them, so a malformed
            # entry would refuse every swap of this checkpoint; validate
            # at save, where the publisher can still fix it
            from dsin_tpu_torch.serve.quality import validate_goldens
            bad = validate_goldens(extra["canary"])
            if bad is not None:
                raise ValueError(
                    f"manifest_extra['canary'] is malformed ({bad}) — "
                    f"record the structure serve/quality.py "
                    f"goldens_struct builds (CompressionService"
                    f".canary_goldens returns it)")
        manifest.update(extra)
    return manifest


def _restore_like(template, loaded, what: str):
    """`loaded` checked against the template's structure (dict keys at
    every level; a leaf where the template has a leaf), as flax's
    `from_state_dict` checks it."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(template):
            raise ValueError(
                f"{what}: the checkpoint's keys "
                f"{sorted(loaded) if isinstance(loaded, dict) else loaded!r}"
                f" do not match the model's {sorted(template)}")
        return {k: _restore_like(template[k], loaded[k], f"{what}/{k}")
                for k in template}
    if isinstance(loaded, dict):
        raise ValueError(f"{what}: the checkpoint holds a tree where the "
                         f"model has an array")
    return loaded


def _prev_dirs(parent: str, name: str) -> List[str]:
    """Rotated `<name>.prev-NNNNNN` siblings, oldest first."""
    prefix = f"{name}.prev-"
    try:
        entries = os.listdir(parent)
    except OSError:
        return []
    return sorted(os.path.join(parent, e) for e in entries
                  if e.startswith(prefix))


def _rescue_nested_dirs(src_dir: str, live_dir: str) -> None:
    """Move foreign subdirectories (nested checkpoints: a checkpoint's own
    payload is files only) out of a rotated-aside dir into the live dir;
    the live dir's copy, when one exists, is newer and wins."""
    try:
        entries = os.listdir(src_dir)
    except OSError:
        return
    moved = False
    for entry in entries:
        src = os.path.join(src_dir, entry)
        dst = os.path.join(live_dir, entry)
        if os.path.isdir(src) and not os.path.exists(dst):
            try:
                os.rename(src, dst)
                moved = True
            except OSError:
                pass
    if moved:
        _fsync_dir(live_dir)


def _staging_dir(live_dir: str) -> str:
    """A fresh `<live>.tmp-<pid>` sibling, after sweeping the stale ones
    earlier killed writers left."""
    parent, name = os.path.split(live_dir)
    os.makedirs(parent or ".", exist_ok=True)
    for entry in os.listdir(parent):
        if entry.startswith(f"{name}.tmp-"):
            shutil.rmtree(os.path.join(parent, entry), ignore_errors=True)
    tmp = os.path.join(parent, f"{name}.tmp-{os.getpid()}")
    os.makedirs(tmp)
    return tmp


def _swap_in(tmp: str, live_dir: str) -> None:
    """Rotate the live dir (if any) aside to the next `.prev-NNNNNN`, then
    rename the staged dir into its place: a kill between the two renames
    (the `ckpt.swap` fault site) leaves the rotated copy complete."""
    parent, name = os.path.split(live_dir)
    if os.path.isdir(live_dir):
        prevs = _prev_dirs(parent, name)
        next_idx = (int(os.path.basename(prevs[-1]).rsplit("-", 1)[1]) + 1
                    if prevs else 1)
        os.rename(live_dir, os.path.join(parent,
                                         f"{name}.prev-{next_idx:06d}"))
        faults.inject("ckpt.swap")    # the kill window between renames
    os.rename(tmp, live_dir)
    _fsync_dir(parent)


def save_checkpoint(ckpt_dir: str, state: ModelState, *,
                    best_val: Optional[float] = None,
                    extra_meta: Optional[Dict[str, Any]] = None,
                    manifest_extra: Optional[Dict[str, Any]] = None,
                    keep_last: int = 1) -> None:
    """Save the partitions, batch statistics and (where `state` holds one)
    the optimizer state of `state`, durably: the
    live dir is replaced only by a complete, fsynced copy (a kill while
    staging leaves it untouched, a kill between the renames leaves the
    newest `.prev-*` complete). `keep_last` bounds the rotated history."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    parent, name = os.path.split(ckpt_dir)
    tmp = _staging_dir(ckpt_dir)
    files: Dict[str, Dict[str, int]] = {}
    for part, sub in state.params.items():
        fname = f"params_{part}.msgpack"
        files[fname] = _write_msgpack(os.path.join(tmp, fname), sub)
    files["batch_stats.msgpack"] = _write_msgpack(
        os.path.join(tmp, "batch_stats.msgpack"), state.batch_stats)
    if state.opt_state is not None:
        files["opt_state.msgpack"] = _write_msgpack(
            os.path.join(tmp, "opt_state.msgpack"), state.opt_state)
    # manifest before meta: meta.json marks a complete checkpoint
    manifest = build_manifest(state, files=files, extra=manifest_extra)
    _write_bytes_durable(os.path.join(tmp, MANIFEST_NAME),
                         json.dumps(manifest, indent=2).encode())
    meta = {"step": int(state.step),
            "partitions": sorted(state.params.keys())}
    if best_val is not None:
        meta["best_val"] = float(best_val)
    if extra_meta:
        meta.update(extra_meta)
    _write_bytes_durable(os.path.join(tmp, "meta.json"),
                         json.dumps(meta, indent=2).encode())
    _fsync_dir(tmp)

    _swap_in(tmp, ckpt_dir)
    for prev in reversed(_prev_dirs(parent, name)):
        _rescue_nested_dirs(prev, ckpt_dir)
    for old in _prev_dirs(parent, name)[:-keep_last if keep_last else None]:
        _rescue_nested_dirs(old, ckpt_dir)
        shutil.rmtree(old, ignore_errors=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The most recent complete checkpoint for `ckpt_dir`: the dir itself
    when its meta.json exists, else the newest `<dir>.prev-*` that has one
    (a kill between the renames), else None."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    if os.path.exists(os.path.join(ckpt_dir, "meta.json")):
        return ckpt_dir
    parent, name = os.path.split(ckpt_dir)
    for prev in reversed(_prev_dirs(parent, name)):
        if os.path.exists(os.path.join(prev, "meta.json")):
            return prev
    return None


def load_meta(ckpt_dir: str) -> Dict[str, Any]:
    """Parse `meta.json`; corruption or truncation raises a typed
    `IntegrityError`."""
    path = os.path.join(ckpt_dir, "meta.json")
    with open(path, "rb") as f:
        raw = f.read()
    try:
        return json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise IntegrityError(
            f"checkpoint meta {path} is corrupt or truncated "
            f"({len(raw)} bytes): {e} — the save was torn or the file "
            f"rotted; resolve a complete checkpoint via "
            f"latest_checkpoint() instead") from e


def load_manifest(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    """Parse `manifest.json`, or None for a pre-manifest checkpoint; a
    manifest that does not parse raises a typed IntegrityError."""
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return None
    # fault site: a corrupted read must surface as a typed refusal
    raw = faults.corrupt("ckpt.manifest", raw)
    try:
        manifest = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise IntegrityError(
            f"checkpoint manifest {path} is corrupt or truncated "
            f"({len(raw)} bytes): {e} — refusing to trust this "
            f"checkpoint's identity") from e
    if not isinstance(manifest, dict):
        raise IntegrityError(
            f"checkpoint manifest {path} is not a JSON object "
            f"({type(manifest).__name__})")
    return manifest


def verify_manifest(ckpt_dir: str, state: ModelState,
                    partitions: Iterable[str], *,
                    batch_stats_loaded: bool = True, pc_config=None,
                    buckets=None) -> Dict[str, Any]:
    """Check a restored state against the checkpoint's manifest: format
    version, the digest of every partition in `partitions` and of the batch
    statistics, and, where both sides state them, the pc-config hash and
    the bucket ladder. Returns {"status": "verified", "manifest": ...} or
    {"status": "legacy", "manifest": None} for a pre-manifest checkpoint;
    any disagreement raises ManifestMismatch."""
    manifest = load_manifest(ckpt_dir)
    if manifest is None:
        return {"status": "legacy", "manifest": None}
    version = manifest.get("manifest_version")
    if not isinstance(version, int) or version < 1 \
            or version > MANIFEST_VERSION:
        raise ManifestMismatch(
            f"checkpoint {ckpt_dir} has manifest_version {version!r}; "
            f"this loader understands 1..{MANIFEST_VERSION} — refusing "
            f"to guess what a different format promises")
    part_digests = manifest.get("partition_digests", {})
    for part in partitions:
        want = part_digests.get(part)
        if want is None:
            raise ManifestMismatch(
                f"checkpoint {ckpt_dir} manifest records no digest for "
                f"restored partition {part!r} (has: "
                f"{sorted(part_digests)})")
        got = _tree_digest(state.params[part])
        if got != want:
            raise ManifestMismatch(
                f"checkpoint {ckpt_dir} partition {part!r} digest "
                f"mismatch: manifest {want}, restored {got} — the "
                f"restored bytes are not the bytes this manifest "
                f"describes")
    if batch_stats_loaded and "batch_stats_digest" in manifest:
        got = _tree_digest(state.batch_stats)
        if got != manifest["batch_stats_digest"]:
            raise ManifestMismatch(
                f"checkpoint {ckpt_dir} batch_stats digest mismatch: "
                f"manifest {manifest['batch_stats_digest']}, restored "
                f"{got}")
    if pc_config is not None and "pc_config_sha256" in manifest:
        got = config_sha256(pc_config)
        if got != manifest["pc_config_sha256"]:
            raise ManifestMismatch(
                f"checkpoint {ckpt_dir} was trained with a different "
                f"probability-model config (manifest pc hash "
                f"{manifest['pc_config_sha256']}, loader built {got}) — "
                f"its entropy streams would not decode against this "
                f"model")
    if buckets is not None and manifest.get("buckets") is not None:
        want_b = [list(b) for b in manifest["buckets"]]
        got_b = [list(b) for b in buckets]
        if want_b != got_b:
            raise ManifestMismatch(
                f"checkpoint {ckpt_dir} was published for bucket ladder "
                f"{want_b}, this service runs {got_b} — a swapped-in "
                f"model must serve the SAME ladder or routed streams "
                f"break")
    return {"status": "verified", "manifest": manifest}


def verify_files(ckpt_dir: str, manifest: Dict[str, Any]) -> Dict[str, int]:
    """CRC-check every payload file the manifest lists against the bytes on
    disk. Returns {"files": n, "bytes": total}; a size or CRC disagreement
    raises a typed IntegrityError."""
    files = manifest.get("files") or {}
    total = 0
    for fname, want in files.items():
        path = os.path.join(ckpt_dir, fname)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise IntegrityError(
                f"checkpoint {ckpt_dir} is missing {fname!r} that its "
                f"manifest lists") from None
        if len(data) != want.get("bytes") or \
                frame_crc(data) != want.get("crc32"):
            raise IntegrityError(
                f"checkpoint file {path} does not match its manifest "
                f"entry (got {len(data)} bytes crc 0x{frame_crc(data):08x}, "
                f"manifest says {want}) — rotted or torn; refusing it")
        total += len(data)
    return {"files": len(files), "bytes": total}


def replicate_checkpoint(ckpt_dir: str, dest_dir: str, *,
                         keep_last: int = 1) -> Dict[str, Any]:
    """Copy the resolved latest checkpoint of `ckpt_dir` (the live dir, or
    the newest complete `.prev-*` after a kill in the swap window) to
    `dest_dir`, a path a second host adopts the same versioned model from.

    Every payload byte is CRC-checked against the manifest on both sides:
    the source read and a read-back of the staged copy (typed
    `IntegrityError`). The manifest, then `meta.json`, are written last,
    and the staged dir swaps in through the same rotate-and-rename as a
    save (`ckpt.swap` between the renames), so a kill never leaves a torn
    destination. A manifest-less source is refused with `ManifestMismatch`.
    Returns {src, dest, files, bytes, params_digest}."""
    src = latest_checkpoint(ckpt_dir)
    if src is None:
        raise FileNotFoundError(
            f"no complete checkpoint to replicate at {ckpt_dir}")
    manifest = load_manifest(src)
    if manifest is None:
        raise ManifestMismatch(
            f"checkpoint {src} has no manifest — refusing to replicate "
            f"an unversioned checkpoint (a peer host could never verify "
            f"what it adopted)")
    verify_files(src, manifest)

    dest_dir = os.path.abspath(dest_dir)
    parent, name = os.path.split(dest_dir)
    tmp = _staging_dir(dest_dir)
    total = 0
    for fname, want in (manifest.get("files") or {}).items():
        with open(os.path.join(src, fname), "rb") as f:
            data = f.read()
        if frame_crc(data) != want.get("crc32"):
            raise IntegrityError(
                f"source file {os.path.join(src, fname)} changed under "
                f"the replication (crc mismatch vs manifest)")
        dst_path = os.path.join(tmp, fname)
        _write_bytes_durable(dst_path, data)
        with open(dst_path, "rb") as f:
            back = f.read()
        if frame_crc(back) != want.get("crc32"):
            raise IntegrityError(
                f"replicated file {dst_path} failed its read-back CRC — "
                f"the copy corrupted in transit")
        total += len(data)
    # manifest, then meta last: meta present => everything it names present
    for fname in (MANIFEST_NAME, "meta.json"):
        with open(os.path.join(src, fname), "rb") as f:
            _write_bytes_durable(os.path.join(tmp, fname), f.read())
    _fsync_dir(tmp)
    _swap_in(tmp, dest_dir)
    for old in _prev_dirs(parent, name)[:-keep_last if keep_last else None]:
        shutil.rmtree(old, ignore_errors=True)
    return {"src": src, "dest": dest_dir,
            "files": len(manifest.get("files") or {}), "bytes": total,
            "params_digest": manifest.get("params_digest")}


def restore_partitions(ckpt_dir: str, state: ModelState,
                       partitions: Iterable[str], *,
                       load_opt_state: bool = False,
                       load_batch_stats: bool = True) -> ModelState:
    """Restore the named partitions into `state`, leaving the rest at their
    current values. A missing partition file raises FileNotFoundError
    (restoring 'sinet' from an AE-only checkpoint is a real error).
    `load_opt_state` also restores the optimizer state, checked against
    `state.opt_state`'s structure, and the step from `meta.json`."""
    params = dict(state.params)
    for part in partitions:
        path = os.path.join(ckpt_dir, f"params_{part}.msgpack")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"checkpoint {ckpt_dir} has no partition {part!r}")
        params[part] = _restore_like(state.params[part], _read_msgpack(path),
                                     f"params_{part}")
    batch_stats = state.batch_stats
    if load_batch_stats:
        bs_path = os.path.join(ckpt_dir, "batch_stats.msgpack")
        if os.path.exists(bs_path):
            batch_stats = _restore_like(state.batch_stats,
                                        _read_msgpack(bs_path), "batch_stats")
    opt_state, step = state.opt_state, state.step
    if load_opt_state:
        if state.opt_state is None:
            raise ValueError("load_opt_state needs a state that holds an "
                             "optimizer state to restore into")
        opt_state = _restore_like(state.opt_state, _read_msgpack(
            os.path.join(ckpt_dir, "opt_state.msgpack")), "opt_state")
        step = int(load_meta(ckpt_dir)["step"])
    return state._replace(params=params, batch_stats=batch_stats,
                          opt_state=opt_state, step=step)


def restore_for_mode(ckpt_dir: str, state: ModelState,
                     ae_config) -> ModelState:
    """The JAX package's mode logic: always the AE partitions
    (encoder/decoder/centers/probclass); with `load_train_step`, also the
    optimizer state and step, and siNet unless AE_only (resuming SI
    training); siNet too for a test-only SI run."""
    parts = list(AE_PARTITIONS)
    load_opt = bool(ae_config.load_train_step)
    ae_only = bool(ae_config.AE_only)
    if load_opt and not ae_only:
        parts.append("sinet")
    elif (ae_config.test_model and not ae_config.train_model
          and not ae_only):
        parts.append("sinet")
    return restore_partitions(ckpt_dir, state, parts,
                              load_opt_state=load_opt)


def write_sidecars(root: str, model_name: str, ae_config, pc_config,
                   iteration: int, total_iterations: int,
                   best_val: float) -> None:
    """`last_saved_*.txt` + `configs_*.txt` sidecars."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, f"last_saved_{model_name}.txt"), "w") as f:
        f.write(f"{os.path.join(root, model_name)}\n"
                f"last saved iteration number: {iteration}/{total_iterations}\n"
                f"last saved val loss: {best_val}")
    cfg_path = os.path.join(root, f"configs_{model_name}.txt")
    if not os.path.exists(cfg_path):
        with open(cfg_path, "w") as f:
            f.write("#  ae configs:\n" + str(ae_config))
            f.write("\n\n#  pc configs:\n" + str(pc_config))


def model_name_for(ae_config, timestamp: str) -> str:
    """'target_bpp<bpp>_<AE_only_|sinet_><ts>'."""
    target_bpp = ae_config.H_target / (64.0 / ae_config.num_chan_bn)
    mode = "_AE_only_" if ae_config.AE_only else "_sinet_"
    return f"target_bpp{target_bpp}{mode}{timestamp}"
