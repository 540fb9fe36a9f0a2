"""The patch search with the side image's width sharded over the mesh's
'spatial' axis (counterpart of the JAX package's `parallel/spatial.py`).

Each rank of a data row correlates every x-hat patch against its own
column block of y-hat only, so its score map is O(Hc * Wc * P / S); only
reductions cross ranks, never the map:

  1. halo: each shard appends its right neighbour's first patch_w - 1
     columns (the last shard zeros), the columns its last windows need;
  2. each shard reduces its masked score map (materialized, or in row
     chunks through `ops/sifinder.chunked_score_argmax`, the tiled search's
     scan body) to P (value, global flat index) candidates and gathers the
     P candidate patches from its haloed ORIGINAL y columns;
  3. one gather over 'spatial' of S * P scalars and S * P patches; the
     winner of each patch is the lowest global flat index among the
     max-valued shards, which is the unsharded arg-max's first-maximum
     rule (shards cover ascending column ranges, a local arg-max picks the
     first maximum), so the indices are the unsharded search's.

The mask's factors multiply first, as the unsharded search's combined
prior (`scores * (gh * gw)`), and columns at or past Wc (the last shard's
right edge) score -inf. Pearson only: the L2 mode's mask discount needs the
whole map's mean.

The search is the only sharded part (`parallel/data_parallel.py`): the
convolutions run whole on every spatial rank, which holds its data row's
whole images. There is no Pallas kernel here (the JAX module runs the XLA
search), so the shard search is the plain route: on a card under 'auto' the
row-tiled one (`shard_row_chunk`), whose memory is one row chunk of the
shard's map.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dsin_tpu_torch.ops import color as color_lib
from dsin_tpu_torch.ops import sifinder
from dsin_tpu_torch.ops.patches import assemble_patches, extract_patches
from dsin_tpu_torch.parallel.mesh import SPATIAL_AXIS, Mesh

INT_MAX = torch.iinfo(torch.int64).max


def shard_row_chunk(config, device_type: str) -> Optional[int]:
    """The row chunk of the shard search, or None for the materialized
    shard map: the JAX package tiles its shards under
    `sifinder_impl = 'xla_tiled'` (here 'tiled'); on a card 'auto' tiles
    too, as the one-card dispatch never materializes a map there."""
    impl = sifinder.sifinder_impl(config)
    if impl == "tiled" or (impl == "auto" and device_type == "cuda"):
        return sifinder.sifinder_row_chunk(config)
    return None


def check_model(model) -> None:
    """The width-sharded search serves the SI path in Pearson mode only:
    an AE-only model has no search, and the L2 mode's mask discount needs
    the whole score map's mean."""
    if model.ae_only:
        raise ValueError("the width-sharded steps are the SI path; AE_only "
                         "models have no search — use the data-parallel or "
                         "the one-rank step")
    if sifinder.use_l2(model.ae_config):
        raise ValueError("the width-sharded search is Pearson-only: "
                         "use_L2andLAB needs the whole score map's mean")


def width_shard(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's block of columns of (N, H, W, C) `t`."""
    n_sp, s = mesh.shape[SPATIAL_AXIS], mesh.spatial_index
    cols = t.shape[2] // n_sp
    return t[:, :, s * cols:(s + 1) * cols]


def halo_from_right(mesh: Mesh, z: torch.Tensor, halo: int) -> torch.Tensor:
    """(..., N, H, Wl, C) -> (..., N, H, Wl + halo, C): the right
    neighbour's first `halo` columns appended; the last shard appends
    zeros (global positions out of range)."""
    n_sp, s = mesh.shape[SPATIAL_AXIS], mesh.spatial_index
    edges = mesh.all_gather(z[..., :halo, :], SPATIAL_AXIS)
    recv = edges[s + 1] if s + 1 < n_sp else torch.zeros_like(edges[0])
    return torch.cat([z, recv], dim=-2)


def _local_candidates(x_dec, y_img_h, y_dec_h, gh, gw_l, cols_valid,
                      patch_h, patch_w, wc, col0, conv_dtype, row_chunk):
    """One pair's shard search: x_dec (H, W, 3) whole; y_img_h / y_dec_h
    (H, Wl + halo, 3) this shard's columns with their halo. -> (best value
    (P,), global flat index (P,), candidate patches (P, ph, pw, 3))."""
    prep = sifinder.build_side_prep(y_img_h, y_dec_h, patch_h, patch_w,
                                    conv_dtype=conv_dtype)
    hc, wl = prep.inv_window_std.shape
    q = color_lib.search_transform(extract_patches(x_dec, patch_h, patch_w))
    xn = sifinder.normalized_patches(q)
    p_count = q.shape[0]
    if row_chunk is None:
        scores = (sifinder._correlate(xn, prep.r_img, conv_dtype)
                  * prep.inv_window_std[..., None])
        scores = scores * (gh[:, None, :] * gw_l[None, :, :])
        scores = torch.where(cols_valid[None, :, None], scores,
                             float("-inf"))
        flat = scores.reshape(hc * wl, p_count)
        best_local = torch.argmax(flat, dim=0)
        best_val = torch.gather(flat, 0, best_local[None])[0]
    else:
        num_chunks = -(-hc // row_chunk)
        pad = num_chunks * row_chunk - hc
        r_pad = sifinder._pad_rows(prep.r_img, num_chunks * row_chunk
                                   + patch_h - 1 - prep.r_img.shape[0])
        inv_pad = sifinder._pad_rows(prep.inv_window_std, pad)
        gh_t = sifinder._pad_rows(gh, pad).t().contiguous()    # (P, rows)
        gw_t = gw_l.t().contiguous()                           # (P, Wl)

        def mask_chunk(scores, r0):
            scores = scores * (gh_t[:, r0:r0 + row_chunk, None]
                               * gw_t[:, None, :])
            return torch.where(cols_valid[None, None, :], scores,
                               float("-inf"))

        best_val, best_local = sifinder.chunked_score_argmax(
            xn, r_pad, inv_pad, hc, row_chunk, mask_chunk, patch_h,
            conv_dtype)
        best_local = best_local.long()
    rows = torch.div(best_local, wl, rounding_mode="floor")
    cols_l = best_local % wl
    cand = sifinder.gather_patches(y_img_h, rows, cols_l, patch_h, patch_w)
    return best_val, rows * wc + col0 + cols_l, cand


def build_sharded_search(mesh: Mesh, patch_h: int, patch_w: int,
                         img_h: int, img_w: int, use_mask: bool = True,
                         conv_dtype: torch.dtype = torch.float32,
                         row_chunk: Optional[int] = None):
    """(x_dec (N, H, W, 3), y_img, y_dec (N, H, W / S, 3) this rank's width
    shards) -> (y_syn (N, H, W, 3), best value (N, P), best global flat
    index (N, P)), every rank of the data row getting the same. N is this
    rank's rows. `conv_dtype` is the config's `sifinder_dtype` reading
    (`ops/sifinder.sifinder_conv_dtype`); `row_chunk` None materializes the
    shard's map, an int scans it in row chunks. Raises ValueError where the
    width does not split into shards and patches, or a shard is narrower
    than the halo (a window would straddle more than two shards)."""
    hc, wc = img_h - patch_h + 1, img_w - patch_w + 1
    p_count = (img_h // patch_h) * (img_w // patch_w)
    n_sp = mesh.shape[SPATIAL_AXIS]
    if img_w % n_sp or img_w % patch_w:
        raise ValueError(f"width {img_w} must divide evenly into {n_sp} "
                         f"shards and {patch_w}-wide patches")
    halo = patch_w - 1
    w_local = img_w // n_sp
    if w_local < halo:
        raise ValueError(
            f"shard width {w_local} narrower than the search halo {halo}: "
            f"windows could straddle >2 shards (halo exchange only reaches "
            f"the immediate right neighbor)")
    if use_mask:
        gh_np, gw_np = sifinder.gaussian_position_mask_factors(
            img_h, img_w, patch_h, patch_w)
    else:
        gh_np = np.ones((hc, p_count), np.float32)
        gw_np = np.ones((wc, p_count), np.float32)
    # gw padded to the sharded width so the last shard's slice is whole
    # (its rows past Wc score -inf through cols_valid)
    gw_np = np.pad(gw_np, ((0, img_w - wc), (0, 0)))
    col0 = mesh.spatial_index * w_local
    cols_valid_np = (col0 + np.arange(w_local)) < wc
    consts = {}

    def on(dev):
        if dev not in consts:
            consts[dev] = (torch.from_numpy(gh_np).to(dev),
                           torch.from_numpy(
                               gw_np[col0:col0 + w_local]).to(dev),
                           torch.from_numpy(cols_valid_np).to(dev))
        return consts[dev]

    def search(x_dec, y_img, y_dec):
        gh, gw_l, cols_valid = on(x_dec.device)
        halos = halo_from_right(mesh, torch.stack([y_img, y_dec]), halo)
        found = [_local_candidates(
            x_dec[i], halos[0, i], halos[1, i], gh, gw_l, cols_valid,
            patch_h, patch_w, wc, col0, conv_dtype, row_chunk)
            for i in range(x_dec.shape[0])]
        # S x (2P scalars + P patches) a pair: values and indices ride one
        # float64 gather (both exact there)
        keys = torch.stack([torch.stack([v.double(), f.double()])
                            for v, f, _ in found])            # (N, 2, P)
        keys_g = mesh.all_gather(keys, SPATIAL_AXIS)           # (S, N, 2, P)
        cand_g = mesh.all_gather(torch.stack([c for _, _, c in found]),
                                 SPATIAL_AXIS)                 # (S, N, P, ...)
        vals_g = keys_g[:, :, 0].float()
        flat_g = keys_g[:, :, 1].long()
        best_val = vals_g.max(dim=0).values                    # (N, P)
        is_max = vals_g == best_val[None]
        winner = torch.argmin(torch.where(
            is_max, flat_g, torch.full_like(flat_g, INT_MAX)), dim=0)
        best_flat = torch.gather(flat_g, 0, winner[None])[0]
        n, p = winner.shape
        patches = cand_g[winner, torch.arange(n, device=winner.device)[:, None],
                         torch.arange(p, device=winner.device)[None, :]]
        y_syn = assemble_patches(patches, x_dec.shape[1], img_w)
        return y_syn, best_val, best_flat

    return search


def build_sharded_synthesize(mesh: Mesh, patch_h: int, patch_w: int,
                             img_h: int, img_w: int, use_mask: bool = True,
                             conv_dtype: torch.dtype = torch.float32,
                             row_chunk: Optional[int] = None):
    """`build_sharded_search`'s y_syn alone: (x_dec, y_img shard, y_dec
    shard) -> y_syn, to compose into larger steps (the counterpart of the
    JAX package's `build_synthesize_shmap`)."""
    search = build_sharded_search(mesh, patch_h, patch_w, img_h, img_w,
                                  use_mask, conv_dtype, row_chunk)
    return lambda x_dec, y_img, y_dec: search(x_dec, y_img, y_dec)[0]


def make_spatial_synthesize(mesh: Mesh, patch_h: int, patch_w: int,
                            img_h: int, img_w: int, use_mask: bool = True):
    """(x_dec, y_img, y_dec) -> y_syn, no gradient: x_dec this rank's rows
    (`mesh.shard_batch`), y_img and y_dec its rows and width columns
    (`mesh.shard_images`); y_syn its rows, whole, the same on every rank
    of the data row. Pearson with the standard Gaussian prior, or none, at
    float32: the indices of `ops/sifinder.synthesize_side_image`."""
    fn = build_sharded_synthesize(mesh, patch_h, patch_w, img_h, img_w,
                                  use_mask)

    @torch.no_grad()
    def synthesize(x_dec, y_img, y_dec):
        return fn(x_dec, y_img, y_dec)

    return synthesize


def make_spatial_inference_step(model, mesh: Mesh, img_h: int, img_w: int):
    """The model's inference with the search width-sharded: (x, y) this
    rank's rows (`mesh.shard_batch`), every column -> dict with x_dec,
    x_with_si, y_syn, bpp (of these rows), the same on every rank of the
    data row. The convs run whole on each rank (`parallel/data_parallel.py`
    on why); only the search is sharded."""
    from dsin_tpu_torch.models.probclass import bitcost_to_bpp

    check_model(model)
    cfg = model.ae_config
    ph, pw = (int(v) for v in cfg.y_patch_size)
    syn = build_sharded_synthesize(
        mesh, ph, pw, img_h, img_w, bool(cfg.use_gauss_mask),
        conv_dtype=sifinder.sifinder_conv_dtype(cfg),
        row_chunk=shard_row_chunk(cfg, model.centers.device.type))

    @torch.inference_mode()
    def infer(x, y):
        dev = model.centers.device
        x, y = (torch.as_tensor(t, dtype=torch.float32, device=dev)
                for t in (x, y))
        enc = model.encode(x)
        x_dec = model.decode(enc.qbar)
        y_dec = model.decode(model.encode(y).qbar)
        y_syn = syn(x_dec, width_shard(mesh, y), width_shard(mesh, y_dec))
        return {"x_dec": x_dec, "x_with_si": model.apply_sinet(x_dec, y_syn),
                "y_syn": y_syn,
                "bpp": bitcost_to_bpp(model.bitcost(enc.qbar, enc.symbols),
                                      x)}

    return infer
