"""The port's from-scratch forward against the JAX package's `entry()`.

`__graft_entry__.entry()` gives the JAX forward, its seeded weights and
inputs at the tiny configuration (40x48, 20x24 patches); the weights go
through `bridge.py` into the port, and both forwards run on the same inputs.

Tolerances: bpp agrees to rtol 1e-5 (probclass convs in float32); x_with_si
to 1e-3 on the [0, 255] scale (float-tolerance nets). The patch matches must
be identical for that, so the test first asserts that the port's own search
has a top-two margin above 1e-4 for every patch (the nets agree to ~1e-5).
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from dsin_tpu_torch import bridge
from dsin_tpu_torch.entry import make_forward, tiny_configs
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops import sifinder as sf
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, PH, PW = 40, 48, 20, 24


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry_for_torch_tests", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    fn, (params, stats, x, y) = _graft_entry().entry()
    x_si, bpp = jax.jit(fn)(params, stats, x, y)
    params, stats = (jax.tree_util.tree_map(np.asarray, t)
                     for t in (params, stats))
    return (params, stats, np.array(x), np.array(y), np.array(x_si),
            float(bpp))


def _port_model(reference, impl=None):
    params, stats = reference[:2]
    ae, pc = tiny_configs()
    if impl is not None:
        ae = ae.replace(sifinder_impl=impl)
    model = build_model(ae, pc, device="cpu")
    model.load_state_dict(bridge.state_dict_from_jax(params, stats),
                          strict=True)
    return model


def test_port_search_margins_are_clear(reference):
    x, y = reference[2:4]
    model = _port_model(reference)
    with torch.no_grad():
        x_dec = model.decode(model.encode(torch.from_numpy(x)).qbar)
        y_dec = model.decode(model.encode(torch.from_numpy(y)).qbar)
    mask = sf.gaussian_position_mask(H, W, PH, PW)
    res = sf.search_single(x_dec[0], torch.from_numpy(y[0]), y_dec[0], mask,
                           PH, PW)
    top2 = torch.topk(res.score_map.reshape(-1, res.score_map.shape[-1]), 2,
                      dim=0).values
    assert float((top2[0] - top2[1]).min()) > 1e-4


@pytest.mark.parametrize("impl", ["auto", "torch", "kernel"])
def test_entry_forward_matches_jax(reference, impl):
    x, y, want_x_si, want_bpp = reference[2:]
    forward = make_forward(_port_model(reference, impl), H, W)
    x_si, bpp = forward(torch.from_numpy(x), torch.from_numpy(y))
    assert tuple(x_si.shape) == want_x_si.shape
    np.testing.assert_allclose(x_si.numpy(), want_x_si, rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(bpp), want_bpp, rtol=1e-5)
