"""The port's package boundary: what it imports, its config DSL copy, and
that its entry points refuse to fall back to the CPU or to the plain search.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dsin_tpu import config as jax_config
from dsin_tpu_torch import config as torch_config
from dsin_tpu_torch import entry as entry_lib
from dsin_tpu_torch import native_build
from dsin_tpu_torch import runtime
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.ops import sifinder_kernel as sk
from dsin_tpu_torch.serve.device import DeviceServer
from dsin_tpu_torch.serve.service import CompressionService, ServiceConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "dsin_tpu_torch")
JAX_CONFIGS = os.path.join(REPO, "dsin_tpu", "configs")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dsin_tpu", "msgpack", "PIL")


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PACKAGE):
        files += [os.path.join(root, n) for n in sorted(names)
                  if n.endswith(".py")]
    return files


def test_importing_the_port_loads_no_jax():
    """Every module of the package, and chip_smoke, in a fresh interpreter:
    jax, flax, optax, msgpack, PIL and the JAX package stay out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dsin_tpu_torch\n"
        "for m in pkgutil.walk_packages(dsin_tpu_torch.__path__, "
        "'dsin_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(n for n in sys.modules "
        "if n.startswith('dsin_tpu_torch'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = set(proc.stdout.split())
    assert len(loaded) >= 40, proc.stdout
    assert {f"dsin_tpu_torch.coding.{m}" for m in (
        "rans", "incremental", "probclass_kernel", "codec", "loader",
        "cli")} | {f"dsin_tpu_torch.{m}" for m in (
            "utils.integrity", "utils.flax_msgpack", "native_build", "main",
            "train.checkpoint", "train.losses", "train.step", "train.optim",
            "utils.signals", "utils.logging", "ops.metrics",
            "ops.msssim", "data.png", "data.manifest", "data.loader",
            "data.synthetic", "eval.msssim_np", "eval.reporting",
            "ops.color", "ops.sifinder", "serve.device",
            "tools.cityscapes_chip", "serve.service", "serve.batcher",
            "serve.buckets", "serve.metrics", "serve.trace",
            "serve.session", "serve.swap", "utils.retry",
            "utils.faults", "utils.profiling", "eval.rd_sweep",
            "eval.synthetic_rd", "tools.rd_delta", "serve.router",
            "serve.protocol", "serve.autoscale", "serve.federation",
            "tools.ckpt_gc")} <= loaded, \
        proc.stdout


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_names_no_jax_module(path):
    """Static: no import of, and no module-name string for, jax / flax /
    optax / msgpack / PIL / the JAX package (file paths inside it may be
    cited in comments)."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.value in FORBIDDEN or node.value.startswith(
                    tuple(f + "." for f in FORBIDDEN)):
                names = [node.value]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, node.lineno,
                                                         name)


def test_config_module_is_a_verbatim_copy():
    jax_src = open(os.path.join(REPO, "dsin_tpu", "config.py")).read()
    assert open(torch_config.__file__).read() == jax_src


@pytest.mark.parametrize("name", sorted(os.listdir(JAX_CONFIGS)))
def test_every_config_file_parses_equal(name):
    path = os.path.join(JAX_CONFIGS, name)
    try:
        expected = jax_config.parse_config_file(path)
    except jax_config.ConfigError as err:
        with pytest.raises(torch_config.ConfigError,
                           match=re.escape(str(err))):
            torch_config.parse_config_file(path)
        return
    got = torch_config.parse_config_file(path)
    assert got.to_dict() == expected.to_dict()
    assert str(got) == str(expected)


@pytest.mark.parametrize("name", ["ae_kitti_stereo", "pc_default",
                                  "ae_cityscapes_stereo",
                                  "ae_synthetic_stereo",
                                  "ae_synthetic_micro",
                                  "ae_synthetic_micro_long"])
def test_bundled_configs_are_copies(name):
    with open(os.path.join(JAX_CONFIGS, name)) as f:
        expected = f.read()
    with open(runtime.config_path(name)) as f:
        assert f.read() == expected


@pytest.mark.parametrize("make", ["build_model", "server", "entry",
                                  "service"])
def test_entry_points_raise_without_a_card(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ae, pc = entry_lib.tiny_configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if make == "build_model":
            build_model(ae, pc)
        elif make == "server":
            DeviceServer(ae, pc)
        elif make == "service":
            CompressionService(ServiceConfig(
                runtime.config_path("ae_kitti_stereo"),
                runtime.config_path("pc_default"))).start()
        else:
            entry_lib.entry()


def test_entry_points_turn_tf32_off():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    runtime.resolve_device("cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_entry_points_pin_deterministic_cudnn():
    """cuDNN's default transposed-convolution algorithm may sum in another
    order from call to call; equal symbols must decode to equal images."""
    torch.backends.cudnn.deterministic = False
    runtime.resolve_device("cpu")
    assert torch.backends.cudnn.deterministic


def _kernel_operands(device="cpu", dtype=torch.float32):
    b, c, h, w, ph, pw, p = 1, 3, 40, 48, 20, 24, 4
    hc, wc = h - ph + 1, w - pw + 1
    z = dict(device=device, dtype=dtype)
    return (torch.zeros((b, c, h, w), **z),
            torch.zeros((b, p, c * ph * pw), **z),
            torch.zeros((b, hc, wc), **z), torch.zeros((hc, p), **z),
            torch.zeros((p, wc), **z))


def test_kernel_wrapper_refuses_non_fp32():
    ops = list(_kernel_operands())
    ops[1] = ops[1].to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        sk.pearson_argmax(*ops, 20, 24)


def test_kernel_wrapper_checks_shapes():
    ops = list(_kernel_operands())
    ops[3] = torch.zeros((5, 4))
    with pytest.raises(ValueError, match="gh has shape"):
        sk.pearson_argmax(*ops, 20, 24)


def test_non_cpu_tensors_never_reach_the_plain_version():
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises (here: 'meta' tensors raise before any launch)."""
    sk.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.pearson_argmax(*_kernel_operands("meta"), 20, 24)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops = _kernel_operands("meta")
        sk.pearson_argmax_shared(ops[0][0], ops[1], ops[2][0], ops[3],
                                 ops[4], 20, 24)
    assert sk.launch_counts == {"pearson_argmax": 0,
                                "pearson_argmax_shared": 0}


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native_build.nvcc()


@pytest.mark.parametrize("bad", [{"sifinder_impl": "pallas"},
                                 {"use_L2andLAB": True,
                                  "sifinder_impl": "kernel"}])
def test_sifinder_impl_refuses_what_is_not_ported(bad):
    cfg = torch_config.Config(dict({"use_L2andLAB": False}, **bad))
    with pytest.raises((ValueError, NotImplementedError)):
        sifinder_lib.sifinder_impl(cfg)


def test_kernel_impl_refuses_a_custom_mask():
    h, w, ph, pw = 40, 48, 20, 24
    mask = sifinder_lib.gaussian_position_mask(h, w, ph, pw).copy()
    mask[3, 4, 1] *= 1.0001
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (1, h, w, 3)).astype(np.float32))
    cfg = torch_config.Config({"use_L2andLAB": False,
                               "sifinder_impl": "kernel"})
    with pytest.raises(ValueError, match="standard"):
        sifinder_lib.synthesize_side_image(x, x, x, mask, ph, pw, cfg)


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""            # no card, even on a card host
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    proc = _run_smoke(str(tmp_path), str(script))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
