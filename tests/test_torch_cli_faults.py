"""The codec CLI's `io.read` fault site (the JAX package's
`coding/cli.py:143`): `decompress` passes the file's bytes through
`faults.corrupt("io.read", ...)` right after reading them. Without a plan
the site is a no-op; under the same seeded plan the port and the JAX CLI
flip the same bits of the same file and refuse it with the same typed
error and message, before any model is built.

Bounds: exact (decoded images, error types by name, messages, exit codes).
"""

import numpy as np
import pytest

from dsin_tpu.coding import cli as jax_cli
from dsin_tpu.utils import faults as jax_faults
from dsin_tpu_torch.coding import cli
from dsin_tpu_torch.data.png import write_png
from dsin_tpu_torch.entry import tiny_configs
from dsin_tpu_torch.utils import faults
from dsin_tpu_torch.utils.integrity import IntegrityError
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """A DSIM file the port compressed at the tiny configuration, its
    configs, and the reconstruction a clean decompress gives."""
    d = tmp_path_factory.mktemp("io_read")
    ae, pc = tiny_configs()
    (d / "ae").write_text(str(ae))
    (d / "pc").write_text(str(pc))
    x = np.random.default_rng(2).integers(0, 255, (40, 48, 3), np.uint8)
    write_png(x, str(d / "x.png"))
    cli.compress(str(d / "x.png"), str(d / "x.dsin"), str(d / "ae"),
                 str(d / "pc"), seed=3, device="cpu")
    want = cli.decompress_array((d / "x.dsin").read_bytes(), None,
                                str(d / "ae"), str(d / "pc"), device="cpu")
    return d, want


def _plan(pkg, seed, **kw):
    return pkg.FaultPlan([pkg.FaultSpec(site="io.read", action="corrupt",
                                        **kw)], seed=seed)


def test_io_read_is_a_no_op_without_a_plan(stream):
    d, want = stream
    assert faults.active() is None
    info = cli.decompress(str(d / "x.dsin"), str(d / "r.png"),
                          str(d / "ae"), str(d / "pc"), device="cpu")
    assert info["shape"] == (40, 48)
    np.testing.assert_array_equal(cli.read_image(str(d / "r.png")), want)


def test_a_plan_that_does_not_fire_still_visits_the_site(stream):
    d, want = stream
    plan = _plan(faults, 0, after=1)
    with faults.installed(plan):
        cli.decompress(str(d / "x.dsin"), str(d / "r2.png"), str(d / "ae"),
                       str(d / "pc"), device="cpu")
    assert plan.visits["io.read"] == 1 and plan.activations["io.read"] == 0
    np.testing.assert_array_equal(cli.read_image(str(d / "r2.png")), want)


@pytest.mark.parametrize("seed,flips", [(0, 1), (5, 1), (11, 3), (2, 32)])
def test_both_clis_refuse_the_same_corrupted_file(stream, seed, flips):
    d, _ = stream
    errors = []
    for pkg, tool, kw in ((faults, cli, {"device": "cpu"}),
                          (jax_faults, jax_cli, {})):
        plan = _plan(pkg, seed, flips=flips)
        with pkg.installed(plan):
            with pytest.raises(ValueError) as err:
                tool.decompress(str(d / "x.dsin"), str(d / "bad.png"),
                                str(d / "ae"), str(d / "pc"), **kw)
        assert plan.activations["io.read"] == 1
        errors.append(err.value)
    mine, theirs = errors
    assert type(mine).__name__ == type(theirs).__name__
    assert str(mine) == str(theirs)
    assert not (d / "bad.png").exists()


def test_the_cli_exits_typed_on_a_corrupted_read(stream, capsys):
    d, _ = stream
    with faults.installed(_plan(faults, 1)):
        with pytest.raises(SystemExit) as exc:
            cli.main(["decompress", str(d / "x.dsin"), str(d / "b.png"),
                      "--ae_config", str(d / "ae"), "--pc_config",
                      str(d / "pc"), "--device", "cpu"])
    assert exc.value.code == 2
    assert capsys.readouterr().err.startswith("integrity error:")
    with faults.installed(_plan(faults, 1)):
        with pytest.raises(IntegrityError):
            cli.decompress(str(d / "x.dsin"), str(d / "b.png"),
                           str(d / "ae"), str(d / "pc"), device="cpu")
