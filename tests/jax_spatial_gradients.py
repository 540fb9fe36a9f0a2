"""How far the JAX package's train steps over a mesh lie from its
global-batch step, on the CPU's 8 virtual devices (ROADMAP Queue 3).

    python tests/jax_spatial_gradients.py

At the geometry of tests/test_torch_parallel_spatial_step.py (the tiny
configuration at 16x96, 8x12 patches, batch 2, seeded weights), one step of
`make_sharded_train_step` (2 data) and of `make_spatial_train_step`
(spatial 2 and 4, remat on and off) against `build_train_step_fn` under one
jit: per mesh, the gradient leaf farthest from the global step's (its
largest difference over its largest magnitude), how many leaves lie past
the train step's 5e-5, and the loss of each.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dsin_tpu.ops.sifinder import gaussian_position_mask  # noqa: E402
from dsin_tpu.parallel import data_parallel as jax_dp  # noqa: E402
from dsin_tpu.parallel import mesh as jax_mesh  # noqa: E402
from dsin_tpu.train import step as jax_step  # noqa: E402
from dsin_tpu_torch.entry import tiny_configs  # noqa: E402
from torch_parallel_parity import jax_sharded_step  # noqa: E402
from torch_train_parity import leaves  # noqa: E402

H, W, PH, PW = 16, 96, 8, 12


def batch():
    """The seeded batch of tests/test_torch_parallel_spatial_step.py."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    y = np.roll(x, 5, axis=2) + rng.normal(0, 4, x.shape).astype(np.float32)
    return x, np.clip(y, 0, 255).astype(np.float32)


def main() -> None:
    x, y = batch()
    mask = jnp.asarray(gaussian_position_mask(H, W, PH, PW))
    for remat in (True, False):
        ae, pc = tiny_configs(2)
        ae = ae.replace(crop_size=(H, W), eval_crop_size=(H, W),
                        y_patch_size=(PH, PW), remat=remat)
        glob = jax_sharded_step(ae, pc, x, y, 3, lambda jm, tx: jax.jit(
            jax_step.build_train_step_fn(jm, tx, si_mask=mask)))
        ref = leaves(glob["grads"])
        for devices, spatial in ((2, 1), (2, 2), (4, 4), (8, 4)):
            mesh = jax_mesh.make_mesh(num_devices=devices, spatial=spatial)
            if spatial == 1:
                build = (lambda jm, tx, m=mesh: jax_dp.make_sharded_train_step(
                    jm, tx, m, si_mask=mask, donate=False))
            else:
                build = (lambda jm, tx, m=mesh: jax_dp.make_spatial_train_step(
                    jm, tx, m, H, W, donate=False))
            got = leaves(jax_sharded_step(ae, pc, x, y, 3, build)["grads"])
            rel = {k: float(np.abs(got[k] - r).max() / np.abs(r).max())
                   for k, r in ref.items()}
            worst = max(rel, key=rel.get)
            print(f"remat {remat}, {devices} devices, spatial {spatial}: "
                  f"farthest leaf {'/'.join(worst)} {rel[worst]:.3g}; "
                  f"{sum(v > 5e-5 for v in rel.values())} of {len(rel)} "
                  f"leaves past 5e-5", flush=True)


if __name__ == "__main__":
    main()
