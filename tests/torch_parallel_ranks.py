"""Rank functions of the port's parallel tests (`tests/test_torch_parallel_*`).

Each runs in a rank spawned by `dsin_tpu_torch.parallel.launch.run_ranks`
(gloo on the CPU, a `file://` rendezvous) and returns numpy values; the
test process holds them against the JAX package. This module imports torch
and the port only: the ranks never load JAX.
"""

import numpy as np
import torch

from dsin_tpu_torch.config import parse_config
from dsin_tpu_torch.models.dsin import build_model
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.parallel import data_parallel as dp
from dsin_tpu_torch.parallel import mesh as mesh_lib
from dsin_tpu_torch.parallel import spatial as spatial_lib
from dsin_tpu_torch.train.optim import Optimizer


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def mesh_facts(dev, spatial: int):
    """The mesh's layout and collectives seen from one rank of 4."""
    mesh = mesh_lib.make_mesh(spatial=spatial)
    rank = mesh.rank
    batch = np.arange(8 * 2 * 6 * 1, dtype=np.float32).reshape(8, 2, 6, 1)
    rows = mesh_lib.shard_batch(mesh, batch)
    cols = mesh_lib.shard_images(mesh, batch)
    gathered = {axis: mesh.all_gather(torch.tensor([rank]), axis)[:, 0]
                .tolist() for axis in ("data", "spatial")}
    # replicate_state: every rank starts from its own weights
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.fill_(float(rank))
        model.bias.fill_(float(-rank))
    mesh_lib.replicate_state(mesh, model)
    # the batch axis: a mean over the global batch and its gradient
    x = torch.full((2, 3), float(mesh.data_index + 1), requires_grad=True)
    axis = dp.BatchAxis(mesh)
    mean = axis.mean(x * x)
    a, b = axis.means((x, x * x), (0,))
    (mean + a.sum() + b.sum()).backward()
    # the distortions and MS-SSIM of a batch held in blocks by the data axis
    from dsin_tpu_torch.ops import metrics
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (4, 24, 24, 3)).astype(np.float32))
    out = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 255, (4, 24, 24, 3)).astype(np.float32))
    cfg = parse_config("distortion_to_minimize = 'ms_ssim'\nK_ms_ssim = 5000")
    rows_img, rows_out = mesh_lib.shard_batch(mesh, img, out)
    dist = metrics.compute_distortions(cfg, rows_img, rows_out, True, axis)
    return {"coords": mesh.coords,
        "rows": rows, "cols": cols, "gathered": gathered,
        "distortions": [float(getattr(dist, k)) for k in (
            "mae", "mse", "psnr", "ms_ssim", "d_loss_scaled")],
        "weight": model.weight.detach().numpy().copy(),
        "bias": model.bias.detach().numpy().copy(),
        "mean": float(mean), "means": (a.detach().numpy().copy(),
                                       b.detach().numpy().copy()),
        "grad": x.grad.numpy().copy()}


def search_cases(dev, cases):
    """The sharded search on the (2 data, 4 spatial) mesh for each case
    (x, y_img, y_dec, patch_h, patch_w, use_mask, row_chunk), global
    batches of 2: -> per case (coords, y_syn rows, best flat indices)."""
    mesh = mesh_lib.make_mesh(spatial=4)
    out = []
    for x, y_img, y_dec, ph, pw, use_mask, row_chunk in cases:
        h, w = x.shape[1:3]
        search = spatial_lib.build_sharded_search(
            mesh, ph, pw, h, w, use_mask, row_chunk=row_chunk)
        xs = torch.from_numpy(mesh_lib.shard_batch(mesh, x))
        yi, yd = (torch.from_numpy(np.ascontiguousarray(a))
                  for a in mesh_lib.shard_images(mesh, y_img, y_dec))
        with torch.no_grad():
            y_syn, _, flat = search(xs, yi, yd)
        out.append((mesh.coords, y_syn.numpy(), flat.numpy()))
    return out


def inference_case(dev, ae_text, pc_text, x, y, seed):
    """The width-sharded inference step on the (2, 4) mesh against the
    one-rank inference step on this rank's rows."""
    from dsin_tpu_torch.train import step as step_lib
    ae, pc = parse_config(ae_text), parse_config(pc_text)
    mesh = mesh_lib.make_mesh(spatial=4)
    model = build_model(ae, pc, device=dev, seed=seed)
    h, w = x.shape[1:3]
    xs, ys = mesh_lib.shard_batch(mesh, x, y)
    got = spatial_lib.make_spatial_inference_step(model, mesh, h, w)(xs, ys)
    ph, pw = (int(v) for v in ae.y_patch_size)
    want = step_lib.make_inference_step(
        model, si_mask=sifinder_lib.standard_prior(h, w, ph, pw))(xs, ys)
    return {k: (got[k].numpy(), want[k].numpy())
            for k in ("y_syn", "x_with_si", "bpp")}


def train_cases(dev, cases):
    """One train step per case on its mesh, from the seeded weights: each
    case is a dict with 'ae', 'pc' (config texts), 'x', 'y' (the global
    batch), 'spatial' (0: the data-parallel step over every rank; S: the
    width-sharded step over a (ranks / S, S) mesh), 'grad_accum', 'seed'.
    -> per case {metrics, grads, state (parameters and statistics after
    the step), coords}."""
    out = []
    for case in cases:
        ae, pc = parse_config(case["ae"]), parse_config(case["pc"])
        model = build_model(ae, pc, device=dev, seed=case["seed"])
        optimizer = Optimizer(model, ae, pc, 10)
        h, w = case["x"].shape[1:3]
        ph, pw = (int(v) for v in ae.y_patch_size)
        if case["spatial"]:
            mesh = mesh_lib.make_mesh(spatial=case["spatial"])
            step = dp.make_spatial_train_step(
                model, optimizer, mesh, h, w, grad_accum=case["grad_accum"])
        else:
            mesh = mesh_lib.make_mesh()
            step = dp.make_sharded_train_step(
                model, optimizer, mesh,
                si_mask=sifinder_lib.gaussian_position_mask(h, w, ph, pw),
                grad_accum=case["grad_accum"])
        mesh_lib.replicate_state(mesh, model, optimizer)
        x, y = mesh_lib.shard_batch(mesh, case["x"], case["y"])
        _, metrics = step(x, y)
        out.append({
            "coords": mesh.coords,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()},
            "state": _numpy(model.state_dict()),
            "step": optimizer.step})
    return out


def experiment_case(dev, root, ae_text, pc_text, max_steps, cli):
    """`main.Experiment` (or, with `cli`, `main.main`) on this rank, its
    outputs under root/rank<r>: -> {coords, results, state after training,
    the files this rank wrote}."""
    import os

    import torch.distributed as dist

    from dsin_tpu_torch import main as port_main
    rank = dist.get_rank()
    out = os.path.join(root, f"rank{rank}")
    ae, pc = parse_config(ae_text), parse_config(pc_text)
    coords = results = state = None
    if cli:
        paths = {name: os.path.join(root, f"{name}_cli_{rank}")
                 for name in ("ae", "pc")}
        for name, cfg in (("ae", ae), ("pc", pc)):
            with open(paths[name], "w") as f:
                f.write(str(cfg))
        port_main.main(["-ae_config", paths["ae"], "-pc_config", paths["pc"],
                        "--out_root", out, "--device", "cpu",
                        "--max_steps", str(max_steps),
                        "--max_test_images", "1"])
    else:
        exp = port_main.Experiment(ae, pc, out_root=out, device=dev)
        coords = exp.mesh.coords
        results = exp.train(max_steps=max_steps)
        state = _numpy(exp.model.state_dict())
        if exp.writer:
            exp.restore_best_for_test()
            results.update(exp.test(max_images=1))
    written = sorted(os.path.relpath(os.path.join(d, f), out)
                     for d, _, files in os.walk(out) for f in files)
    return {"coords": coords, "results": results, "state": state,
            "written": written}
