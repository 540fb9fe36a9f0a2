"""Host-side test reporting: per-image metrics, score lists, image dumps (a
copy of the JAX package's `eval/reporting.py`, its PNGs written by
`data/png.py` instead of PIL).

Capability parity with the reference's `utils.py` eval helpers:
  * numpy L1 / PSNR / MS-SSIM per test image (reference utils.py:82-99);
  * reconstruction PNG saved as ``<idx>_<bpp>bpp.png`` under the model's
    image directory (reference utils.py:102-111);
  * appended txt score lists — one value per test image — for bpp, L1,
    PSNR, MS-SSIM, plus the x-vs-y_syn MSE and mean per-patch Pearson
    diagnostics (reference utils.py:114-158);
  * ``pearson_per_patch`` (reference utils.py:161-180).

Everything here is pure numpy on host arrays — it runs after device
compute, off the hot path.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from dsin_tpu_torch.data.png import write_png
from dsin_tpu_torch.eval.msssim_np import multiscale_ssim_np


def l1_np(x: np.ndarray, x_out: np.ndarray) -> float:
    """Mean absolute error on int-truncated pixels (reference utils.py:82-85)."""
    return float(np.mean(np.abs(x_out.astype(np.int64) -
                                x.astype(np.int64))))


def mse_np(x: np.ndarray, x_out: np.ndarray) -> float:
    return float(np.mean((x_out.astype(np.int64) -
                          x.astype(np.int64)) ** 2.0))


def psnr_np(x: np.ndarray, x_out: np.ndarray) -> float:
    """PSNR in dB, max_val 255, int-truncated (reference utils.py:87-91).
    Identical images give +inf (numpy division semantics)."""
    mse = mse_np(x, x_out)
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(255.0 ** 2 / mse))


def pearson_per_patch(a: np.ndarray, b: np.ndarray, patch_h: int,
                      patch_w: int) -> np.ndarray:
    """Pearson correlation of corresponding non-overlapping patches.

    a, b: (H, W, C) images; returns (num_patches,) correlations in grid
    row-major order (reference utils.py:161-180). Constant patches give 0.
    """
    h, w = a.shape[:2]
    gh, gw = h // patch_h, w // patch_w
    a = a[:gh * patch_h, :gw * patch_w].astype(np.float64)
    b = b[:gh * patch_h, :gw * patch_w].astype(np.float64)

    def flat_patches(img):
        c = img.shape[-1]
        x = img.reshape(gh, patch_h, gw, patch_w, c)
        return x.transpose(0, 2, 1, 3, 4).reshape(gh * gw, -1)

    pa, pb = flat_patches(a), flat_patches(b)
    pa = pa - pa.mean(axis=1, keepdims=True)
    pb = pb - pb.mean(axis=1, keepdims=True)
    denom = np.sqrt((pa * pa).sum(axis=1) * (pb * pb).sum(axis=1))
    num = (pa * pb).sum(axis=1)
    return np.where(denom > 0, num / np.maximum(denom, 1e-12), 0.0)


def save_image(img: np.ndarray, path: str) -> None:
    """Save an (H, W, 3) float/uint8 [0,255] array as PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(np.clip(np.asarray(img), 0, 255).astype(np.uint8), path)


def image_output_path(image_dir: str, index: int, bpp: float) -> str:
    """``<dir>/<idx>_<bpp:.4f>bpp.png`` (reference utils.py:102-111)."""
    return os.path.join(image_dir, f"{index}_{bpp:.4f}bpp.png")


class ScoreLists:
    """Accumulates per-image eval scores and persists them as txt lists.

    One file per metric, one float per line, appended in test order —
    the reference's `loss_list_saver` contract (utils.py:114-158), which
    downstream RD-curve tooling consumes.
    """

    METRICS = ("bpp", "real_bpp", "l1", "psnr", "ms_ssim",
               "mse_x_ysyn", "pearson_x_ysyn")

    def __init__(self, out_dir: str, model_name: str):
        self.out_dir = out_dir
        self.model_name = model_name
        self.values: Dict[str, List[float]] = {m: [] for m in self.METRICS}
        self._flushed = 0  # images already written by save()

    def add_image(self, x: np.ndarray, x_out: np.ndarray, bpp: float,
                  y_syn: Optional[np.ndarray] = None,
                  patch_size: Optional[Sequence[int]] = None,
                  real_bpp: Optional[float] = None) -> Dict[str, float]:
        """Score one test image; returns this image's metrics. `bpp` is the
        cross-entropy estimate (all the reference ever reports); `real_bpp`,
        when provided, is the measured size of an ACTUAL encoded bitstream
        (coding/) — the capability the reference stubbed."""
        scores = {
            "bpp": float(bpp),
            "l1": l1_np(x, x_out),
            "psnr": psnr_np(x, x_out),
            "ms_ssim": multiscale_ssim_np(x, x_out),
        }
        if real_bpp is not None:
            scores["real_bpp"] = float(real_bpp)
        if y_syn is not None:
            scores["mse_x_ysyn"] = mse_np(x, y_syn)
            if patch_size is not None:
                ph, pw = patch_size
                scores["pearson_x_ysyn"] = float(
                    np.mean(pearson_per_patch(x, y_syn, ph, pw)))
        # every metric gets a row per image (nan when not computed) so line i
        # of every txt file refers to test image i, as in the reference
        for key in self.METRICS:
            self.values[key].append(scores.get(key, float("nan")))
        return scores

    def means(self) -> Dict[str, float]:
        """Per-metric means over the finite values seen so far (nan rows mark
        metrics not computed; inf PSNR from an exact reconstruction must not
        make the whole run's mean inf)."""
        out = {}
        for k, v in self.values.items():
            arr = np.asarray(v, dtype=np.float64)
            arr = arr[np.isfinite(arr)]
            if arr.size:
                out[k] = float(arr.mean())
        return out

    def save(self) -> None:
        """Append rows not yet written; safe to call after every image."""
        os.makedirs(self.out_dir, exist_ok=True)
        n = len(self.values["bpp"])
        for metric in self.METRICS:
            vals = self.values[metric][self._flushed:n]
            if not vals:
                continue
            path = os.path.join(self.out_dir,
                                f"{metric}_list_{self.model_name}.txt")
            with open(path, "a") as f:
                for v in vals:
                    f.write(f"{v}\n")
        self._flushed = n

    @staticmethod
    def load_list(out_dir: str, metric: str, model_name: str) -> np.ndarray:
        path = os.path.join(out_dir, f"{metric}_list_{model_name}.txt")
        with open(path) as f:
            return np.array([float(line) for line in f if line.strip()])
