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
error on that lane, for the service's entropy stage; `load_swap_state`
restores and verifies an incoming checkpoint for the service's hot swap.
The port's modules are fully convolutional and eager, so no image shape is
needed to build them.

The worker-resident codec of the service's process entropy backend (the
JAX package's `coding/loader.py:172-404`): `make_codec_spec` turns a live
codec into a picklable `CodecSpec`, and a spawned pool child rebuilds it
once (`init_worker_codec`) as a host codec that codes mode 2 only, then
serves `worker_encode_batch` / `worker_decode_batch` tasks with it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import sys
import time
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dsin_tpu_torch import bridge, native_build
from dsin_tpu_torch.coding import precision as precision_lib
from dsin_tpu_torch.coding import rans
from dsin_tpu_torch.coding.codec import MODE_WAVEFRONT_NP, BottleneckCodec
from dsin_tpu_torch.config import parse_config, parse_config_file
from dsin_tpu_torch.models.dsin import DSIN, build_model
from dsin_tpu_torch.train import checkpoint as ckpt_lib


def build_at_rung(ae_config, pc_config, device="cuda", seed: int = 0,
                  precision: str = "fp32",
                  ckpt_dir: Optional[str] = None,
                  state: Optional[ckpt_lib.ModelState] = None
                  ) -> Tuple[DSIN, Optional[dict]]:
    """The seeded DSIN of two parsed configs on `device`, cast to the ladder
    rung `precision`, and the checkpoint's verification record (None
    without `ckpt_dir`). With `ckpt_dir` the AE partitions (+ siNet when the
    config builds it) are restored over the seeded weights and verified
    against the checkpoint's manifest (typed `ManifestMismatch`; a
    pre-manifest checkpoint loads with a UserWarning); with `state` (an
    already verified `ModelState`, `load_swap_state`) its trees are loaded
    instead. At a rung other than fp32 the AE config's `compute_dtype`
    follows the rung; the float32 weights are built and restored first,
    cast afterwards (identity is checked against the checkpoint's own
    bytes), and the entropy-critical tripwire runs last."""
    policy = precision_lib.PrecisionPolicy(precision)
    if policy.rung != "fp32":
        ae_config = ae_config.replace(compute_dtype=policy.compute_dtype)
    model = build_model(ae_config, pc_config, device=device, seed=seed)
    record = restore_checkpoint(model, ckpt_dir) if ckpt_dir else None
    if state is not None:
        ckpt_lib.load_state(model, state)
    if policy.rung != "fp32":
        policy.cast_model(model)
        precision_lib.check_entropy_critical(model)
    return model, record


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
                         precision=precision, ckpt_dir=ckpt_dir)[0]


def load_swap_state(ckpt_dir: str, template: ckpt_lib.ModelState, *,
                    pc_config=None, buckets=None, need_sinet: bool = False):
    """Restore an INCOMING checkpoint's partitions (+ 'sinet' with
    `need_sinet`) into a copy of a live model's trees (`template`,
    `train/checkpoint.state_from_model`: the same architecture; its
    structure is the compatibility contract) and verify its manifest, for
    the hot swap (the JAX package's `coding/loader.py:105`). Returns
    (new_state, manifest_info); a wrong partition digest, pc-config hash
    or bucket ladder raises typed `ManifestMismatch`, and a manifest-less
    checkpoint is REFUSED (unlike a cold start, a swap replaces a
    known-good model: adopting an unverifiable one is what manifests
    exist to prevent)."""
    parts = list(ckpt_lib.AE_PARTITIONS)
    if need_sinet:
        parts.append("sinet")
    new_state = ckpt_lib.restore_partitions(ckpt_dir, template, parts)
    info = ckpt_lib.verify_manifest(ckpt_dir, new_state, parts,
                                    pc_config=pc_config, buckets=buckets)
    if info["status"] == "legacy":
        raise ckpt_lib.ManifestMismatch(
            f"checkpoint {ckpt_dir} has no manifest.json — hot-swap "
            f"refuses unversioned checkpoints (re-save it with the "
            f"current trainer to gain a manifest)")
    return new_state, info


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


# -- worker-resident codecs (the service's process entropy backend) -----------
#
# A live BottleneckCodec does not cross a process boundary cheaply, so the
# process backend ships a small picklable SPEC, and each pool child
# rebuilds its codec ONCE at initializer time and warms the per-shape
# schedule cache for the shapes it will serve. The child's codec lives on
# the host and codes mode 2 (the numpy engine) only: the parent holds the
# card, and a child never initialises CUDA.

@dataclass
class CodecSpec:
    """Everything needed to rebuild a bit-identical mode-2 BottleneckCodec
    in another process: the four pre-masked (W, b) pairs of
    `probclass.front_weight_matrices` as float32 numpy arrays, the
    quantizer centers, the pc config as its canonical text, the pad value
    and the coder's scale_bits. `rung` is metadata only: the codec is fp32
    at every rung of the ladder."""
    weights: list
    centers: np.ndarray
    pc_config_text: str
    pad_value: float
    scale_bits: int
    rung: str = "fp32"


def make_codec_spec(codec: BottleneckCodec, rung: str = "fp32") -> CodecSpec:
    """Picklable spec from a live BottleneckCodec (the parent side)."""
    return CodecSpec(
        weights=[(np.array(w, np.float32), np.array(b, np.float32))
                 for w, b in codec.weights],
        centers=np.array(codec.centers, np.float32),
        pc_config_text=str(codec.pc_config),
        pad_value=float(codec.pad_value),
        scale_bits=int(codec.scale_bits),
        rung=str(rung))


def write_codec_spec(spec: CodecSpec, path: str) -> str:
    """Pickle `spec` to `path` (the parent side) -> path. The service hands
    its pool children this path, not the spec: spawn writes a child's
    start-up arguments into a pipe with one blocking write that the child
    reads only after re-importing `__main__`, so arguments beyond the
    pipe's 64 KiB (pc_default's spec is ~190 KB) start the children one
    after another."""
    with open(path, "wb") as f:
        pickle.dump(spec, f, protocol=pickle.HIGHEST_PROTOCOL)
    return path


def codec_from_spec(spec: CodecSpec) -> BottleneckCodec:
    """The host codec a spec describes. Its mode-2 streams are byte-equal
    to the origin codec's: the same float32 matrices, centers, config and
    pad value through the same numpy engine."""
    pc_cfg = parse_config(spec.pc_config_text, name="codec_spec")
    codec = BottleneckCodec(spec.weights, spec.centers, pc_cfg,
                            scale_bits=spec.scale_bits, device="cpu")
    # the spec's value, before the engine (built lazily) reads it
    codec.pad_value = float(spec.pad_value)
    return codec


#: OpenBLAS thread-count entry points, by build: numpy's wheels carry
#: scipy-openblas (64-bit ints, prefixed and suffixed names)
_BLAS_THREADS = (("scipy_openblas_set_num_threads64_",
                  "scipy_openblas_get_num_threads64_"),
                 ("openblas_set_num_threads64_", "openblas_get_num_threads64_"),
                 ("scipy_openblas_set_num_threads",
                  "scipy_openblas_get_num_threads"),
                 ("openblas_set_num_threads", "openblas_get_num_threads"))


def blas_threads(pin: Optional[int] = None) -> list:
    """The thread count of every OpenBLAS loaded in this process, after
    setting it to `pin` when given (what threadpoolctl does). OpenBLAS
    reads OPENBLAS_NUM_THREADS only when it loads, and in a spawned child
    numpy is loaded before any initializer runs, so the count is set
    through the library itself. Empty where no OpenBLAS is loaded."""
    try:
        with open("/proc/self/maps") as f:
            paths = sorted({line.split()[-1] for line in f
                            if "openblas" in line.lower()
                            and line.split()[-1].startswith("/")})
    except OSError:
        return []
    counts = []
    for path in paths:
        lib = ctypes.CDLL(path)
        for set_name, get_name in _BLAS_THREADS:
            if hasattr(lib, set_name) and hasattr(lib, get_name):
                if pin is not None:
                    getattr(lib, set_name).argtypes = [ctypes.c_int]
                    getattr(lib, set_name)(int(pin))
                counts.append(int(getattr(lib, get_name)()))
                break
    return counts


# one codec and one lane ring per POOL CHILD, set once by the initializer
# before any task runs; a ProcessPoolExecutor child runs its tasks one at
# a time, so no lock guards them
_worker_codec: Optional[BottleneckCodec] = None
_worker_rings = None
#: (wall clock at the initializer's start, its seconds), for the ping
_worker_init = (None, None)


def init_worker_codec(spec_path: str,
                      warm_shapes: Sequence[Tuple[int, int, int]] = (),
                      lane_manifest=None) -> None:
    """ProcessPoolExecutor initializer (`spec_path`: where
    `write_codec_spec` wrote the CodecSpec): pin torch and OpenBLAS to one
    thread (the children code side by side, one core each; at its default
    of a thread per core, 4 children's OpenBLAS pools oversubscribed an
    8-core host and a mode-2 pass took 6 s in place of 1), rebuild the
    codec once for this child's lifetime, bind the rANS library the parent
    built, and warm the schedule of every (D, H, W) volume the service's
    buckets map to, so tasks pay coding work only.
    `lane_manifest` (shm transport) attaches this child to the parent's
    lane ring: task payloads arrive as LaneRef descriptors and results
    are written into the reply lane the parent claimed."""
    global _worker_codec, _worker_rings, _worker_init
    t0, wall = time.perf_counter(), time.time()
    torch.set_num_threads(1)
    blas_threads(pin=1)
    if lane_manifest is not None:
        from dsin_tpu_torch.serve import shmlane
        _worker_rings = shmlane.LaneRing.attach(lane_manifest)
    with open(spec_path, "rb") as f:
        _worker_codec = codec_from_spec(pickle.load(f))
    rans.load_library()
    eng = _worker_codec._incremental_engine()
    for shape in warm_shapes:
        eng.schedule(tuple(int(s) for s in shape))
    _worker_init = (wall, time.perf_counter() - t0)


def _resolve_task(data):
    """Inline payloads pass through; a LaneRef is copied out of the
    attached ring WITHOUT freeing it: the parent is the sole allocator and
    reclaims the task lane when the future settles."""
    from dsin_tpu_torch.serve import shmlane
    if not isinstance(data, shmlane.LaneRef):
        return data
    if _worker_rings is None:
        raise shmlane.ShmLaneError(
            "task arrived as a shm lane descriptor but this worker was "
            "initialized without a lane ring — parent and worker "
            "disagree about the transport")
    return _worker_rings.take_obj(data, free=False)


def _lane_reply(result, reply):
    """Ship a task result back through the parent-claimed reply lane when
    it fits (returning the written descriptor), else inline over the pipe:
    the same per-message fallback contract as the request direction. The
    parent frees the reply lane either way."""
    if reply is None or _worker_rings is None:
        return result
    import pickle

    from dsin_tpu_torch.serve import shmlane
    blob = pickle.dumps(result, protocol=pickle.HIGHEST_PROTOCOL)
    if len(blob) < shmlane.SMALL_INLINE_MAX:
        return result
    try:
        return _worker_rings.write_into(reply, blob)
    except shmlane.ShmLaneError:
        return result          # oversize for the lane: inline fallback


def _resident_codec() -> BottleneckCodec:
    if _worker_codec is None:
        raise RuntimeError("entropy worker used before init_worker_codec "
                           "ran (ProcessPoolExecutor initializer missing)")
    return _worker_codec


def worker_ping(settle_s: float = 0.05) -> dict:
    """Worker-residence probe (and warmup vehicle): this child's pid, its
    resident codec's identity, the schedule shapes the initializer warmed,
    whether it initialised CUDA, the top-level modules it imported, the
    native builds it ran, its torch and OpenBLAS threads, and when its
    initializer started (wall clock) and how long it took. The short sleep
    keeps concurrent warmup pings from all landing on one eager child."""
    time.sleep(settle_s)
    codec = _resident_codec()
    return {"pid": os.getpid(), "codec_id": id(codec),
            "schedules": codec._incremental_engine().cached_shapes(),
            "cuda_initialized": bool(torch.cuda.is_initialized()),
            "top_modules": sorted({m.split(".")[0] for m in sys.modules}),
            "native_builds": native_build.build_count(),
            "torch_threads": torch.get_num_threads(),
            "blas_threads": blas_threads(),
            "init_wall": _worker_init[0], "init_s": _worker_init[1]}


def _traced_task(fn, data, trace):
    """Run a coding task in this child, echoing the trace contexts back
    with the child-side coding time: the parent checks the echo against
    what it sent and records the child's coding span. `trace` is an opaque
    picklable tuple; nothing here imports the serve stack."""
    t0 = time.monotonic()
    out = fn(data)
    t1 = time.monotonic()
    return out, {"trace": trace, "pid": os.getpid(),
                 "coding_ms": (t1 - t0) * 1e3}


def _host_decode(payloads) -> list:
    """`decode_batch_isolated` on the resident codec, for mode-2 payloads
    only: any other mode fails its own lane typed. The service's bridge
    decodes those on the card's codec before they reach a child, so a
    child never runs the K3 plain version in its place."""
    codec = _resident_codec()
    out, good, blobs = [None] * len(payloads), [], []
    for i, blob in enumerate(payloads):
        try:
            mode_id, _ = codec._parse_header(blob)
            if mode_id != MODE_WAVEFRONT_NP:
                raise ValueError(
                    f"stream mode {mode_id} is decoded on the card by the "
                    f"service, not in an entropy child (mode 2 only here)")
        except ValueError as exc:
            out[i] = (None, exc)
        else:
            good.append(i)
            blobs.append(blob)
    for i, lane in zip(good, decode_batch_isolated(codec, blobs)):
        out[i] = lane
    return out


def worker_encode_batch(volumes, trace=None, reply=None):
    """Process-pool task: encode N (D, H, W) symbol volumes in mode 2 with
    the resident codec, one native rANS call for the batch with per-lane
    isolation (`encode_batch_isolated`). With `trace`, returns (lanes,
    echo). shm transport: `volumes` may arrive as a LaneRef and `reply` is
    the parent-claimed lane the result is written into."""
    volumes = _resolve_task(volumes)
    run = lambda v: encode_batch_isolated(_resident_codec(), v)  # noqa: E731
    out = run(volumes) if trace is None else _traced_task(run, volumes,
                                                          trace)
    return _lane_reply(out, reply)


def worker_decode_batch(payloads, trace=None, reply=None):
    """Process-pool task: decode N mode-2 payloads with the resident codec
    (`_host_decode`). Payloads arrive CRC-verified: the parent's bridge
    keeps the per-request verify and fault site. `trace` and the lanes as
    in `worker_encode_batch`."""
    payloads = _resolve_task(payloads)
    out = (_host_decode(payloads) if trace is None
           else _traced_task(_host_decode, payloads, trace))
    return _lane_reply(out, reply)
