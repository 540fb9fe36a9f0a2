"""The port's serving device path against the JAX package's serve functions.

`DeviceServer.encode / open_session / decode_si` against
`dsin_tpu.serve.service._make_batched_fns` and `_make_si_fns(model,
for_pallas=False)` on bridged weights, at the tiny configuration with a
session shared by two requests.

Tolerances: symbols exactly equal (asserting first that no z lies within
1e-4 of a centre midpoint); the bpp estimate to rtol 1e-5 against the JAX
probclass bitcost of the same symbols; the decoded SI images to 1e-3 on the
[0, 255] scale, with identical patch matches (the port's search margins are
asserted above 1e-4 first).
"""

import jax
import numpy as np
import pytest
import torch

from dsin_tpu.config import parse_config as jax_parse
from dsin_tpu.models.dsin import DSIN as JaxDSIN
from dsin_tpu.ops import sifinder as jsf
from dsin_tpu.serve import service
from dsin_tpu_torch import bridge
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.models.quantizer import centers_lookup
from dsin_tpu_torch.ops import sifinder as sf
from dsin_tpu_torch.ops import sifinder_kernel as sk
from dsin_tpu_torch.serve.device import DeviceServer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, H, W, PH, PW = 2, 40, 48, 20, 24


@pytest.fixture(scope="module")
def reference():
    ae, pc = tiny_configs(N)
    jmodel = JaxDSIN(jax_parse(str(ae)), jax_parse(str(pc)))
    variables = jmodel.init_variables(jax.random.PRNGKey(1), (N, H, W, 3))
    params, stats = variables.params, variables.batch_stats
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 255, (H, W + 8, 3)).astype(np.float32)
    y = base[:, 8:].copy()
    x = np.clip(np.stack([base[:, :W], base[:, 4:W + 4]])
                + rng.normal(0, 8, (N, H, W, 3)), 0, 255).astype(np.float32)
    encode_fn, _ = service._make_batched_fns(jmodel)
    prep_fn, decode_fn = service._make_si_fns(jmodel, for_pallas=False)
    symbols = encode_fn(params, stats, x)
    factors = jsf.gaussian_position_mask_factors(H, W, PH, PW)
    prep = prep_fn(params, stats, y, factors)
    images = decode_fn(params, stats, symbols, prep)
    qhard = params["centers"][symbols]
    bits = jax.jit(jmodel.bitcost)(params, qhard, symbols)
    bpp = np.asarray(bits).sum(axis=(1, 2, 3)) / (H * W)
    state = bridge.state_dict_from_jax(
        *(jax.tree_util.tree_map(np.asarray, t) for t in (params, stats)))
    return (ae, pc, state, x, y, np.array(symbols), np.array(images),
            bpp)


def _server(reference, impl=None):
    ae, pc, state = reference[:3]
    if impl is not None:
        ae = ae.replace(sifinder_impl=impl)
    server = DeviceServer(ae, pc, device="cpu")
    server.model.load_state_dict(state, strict=True)
    return server


def test_encode_matches_jax(reference):
    x, want_symbols, want_bpp = (reference[3], reference[5], reference[7])
    server = _server(reference)
    with torch.no_grad():
        z = server.model.encode(torch.from_numpy(x)).z.numpy()
    centers = np.sort(server.model.centers.detach().numpy())
    mids = (centers[1:] + centers[:-1]) / 2
    assert np.abs(z[..., None] - mids).min() > 1e-4
    symbols, bpp = server.encode(x)
    assert symbols.dtype == torch.int32
    np.testing.assert_array_equal(symbols.numpy(), want_symbols)
    np.testing.assert_allclose(bpp.numpy(), want_bpp, rtol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "torch", "kernel"])
def test_open_session_and_decode_si_match_jax(reference, impl):
    y, want_symbols, want_images = reference[4], reference[5], reference[6]
    server = _server(reference, impl)
    prep = server.open_session(y)
    assert (prep.y_t is not None) == (impl == "kernel")
    symbols = torch.from_numpy(want_symbols)
    with torch.no_grad():
        x_dec = server.model.decode(centers_lookup(server.model.centers,
                                                   symbols))
    for i in range(N):
        res = sf.search_single(x_dec[i], None, None, None, PH, PW, prep=prep)
        top2 = torch.topk(res.score_map.reshape(-1, res.score_map.shape[-1]),
                          2, dim=0).values
        assert float((top2[0] - top2[1]).min()) > 1e-4
    sk.reset_launch_counts()
    images = server.decode_si(want_symbols, prep)
    assert sk.launch_counts["pearson_argmax_shared"] == 0   # CPU: plain
    assert tuple(images.shape) == (N, H, W, 3)
    assert float(images.min()) >= 0.0 and float(images.max()) <= 255.0
    np.testing.assert_allclose(images.numpy(), want_images, rtol=0,
                               atol=1e-3)
