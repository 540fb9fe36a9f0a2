"""The from-scratch DSIN inference forward, (x, y) -> (x_with_si, bpp)
(counterpart of the JAX package's `__graft_entry__.entry()`).

encode -> decode -> decode of the side image -> patch search against it ->
siNet fusion, plus the probclass bitcost -> bpp. `entry()` returns
`(forward, (x, y))` with seeded weights and inputs, at the tiny test
configuration by default or at the full width of `ae_kitti_stereo` +
`pc_default` (320x1224 eval crop) with `full_width=True`.
"""

from __future__ import annotations

import numpy as np
import torch

from dsin_tpu_torch.config import parse_config, parse_config_file
from dsin_tpu_torch.models.dsin import DSIN, build_model
from dsin_tpu_torch.models.probclass import bitcost_to_bpp
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.runtime import config_path


def tiny_configs(batch_size=1):
    """The tiny test configuration: 40x48 crops, 20x24 patches (the values
    of the JAX package's `__graft_entry__._tiny_configs`)."""
    ae = parse_config(
        f"""
        arch = CVPR
        arch_param_B = 2
        num_chan_bn = 8
        heatmap = True
        num_centers = 6
        centers_initial_range = (-2, 2)
        normalization = 'FIXED'
        AE_only = False
        si_weight = 0.7
        y_patch_size = (20, 24)
        use_gauss_mask = True
        use_L2andLAB = False
        batch_size = {batch_size}
        num_crops_per_img = 1
        crop_size = (40, 48)
        H_target = 0.08
        beta = 500
        distortion_to_minimize = 'mae'
        K_psnr = 100
        K_ms_ssim = 5000
        regularization_factor = 0.0005
        regularization_factor_centers = 0.01
        remat = True
        optimizer = 'ADAM'
        lr_initial = 1e-4
        lr_schedule = 'FIXED'
        train_autoencoder = True
        train_probclass = True
        lr_centers_factor = None
        bn_stats = 'update'
        """)
    pc = parse_config(
        """
        arch = res_shallow
        kernel_size = 3
        arch_param__k = 12
        use_centers_for_padding = True
        regularization_factor = None
        optimizer = 'ADAM'
        lr_initial = 1e-4
        lr_schedule = 'FIXED'
        """)
    return ae, pc


def full_configs():
    """`ae_kitti_stereo` + `pc_default`, bundled in `configs/`."""
    return (parse_config_file(config_path("ae_kitti_stereo")),
            parse_config_file(config_path("pc_default")))


def make_forward(model: DSIN, h: int, w: int):
    """forward(x, y) for (N, h, w, 3) images in [0, 255] -> (x_with_si
    (N, h, w, 3), bpp scalar), with the Gaussian position prior as its
    factors (`sifinder.standard_prior`)."""
    ph, pw = (int(v) for v in model.ae_config.y_patch_size)
    dev = model.centers.device
    mask = sifinder_lib.standard_prior(h, w, ph, pw)

    @torch.inference_mode()
    def forward(x, y):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        y = torch.as_tensor(y, dtype=torch.float32, device=dev)
        enc = model.encode(x)
        x_dec = model.decode(enc.qbar)
        y_dec = model.decode(model.encode(y).qbar)
        y_syn = sifinder_lib.synthesize_side_image(
            x_dec, y, y_dec, mask, ph, pw, model.ae_config)
        x_with_si = model.apply_sinet(x_dec, y_syn)
        bits = model.bitcost(enc.qbar, enc.symbols)
        return x_with_si, bitcost_to_bpp(bits, x)

    return forward


def entry(device="cuda", full_width: bool = False, batch: int = 1,
          seed: int = 0):
    """(forward, (x, y)): the seeded model and seeded inputs on `device`,
    which defaults to the card and raises without one."""
    if full_width:
        ae, pc = full_configs()
        h, w = ae.eval_crop_size
    else:
        ae, pc = tiny_configs(batch)
        h, w = 40, 48
    model = build_model(ae, pc, device=device, seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (batch, h, w, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (batch, h, w, 3)).astype(np.float32)
    dev = model.centers.device
    return make_forward(model, h, w), (torch.from_numpy(x).to(dev),
                                       torch.from_numpy(y).to(dev))
