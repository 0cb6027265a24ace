"""Image quality metrics and their aggregation (counterpart of
matchnerf_tpu/metrics.py), numpy and scipy on the host.

- PSNR: mask-aware (pixels where the mask is True are excluded).
- SSIM: skimage `structural_similarity` defaults (7x7 uniform window, K1
  0.01, K2 0.03, sample covariance) with data_range=2.0: the float default
  skimage infers and the reference inherits, so the published numbers use it.
- LPIPS: `lpips.lpips_distance` (VGG16 + the LPIPS heads) on the eval's
  device, from configs/lpips_vgg_weights.npz where that file exists; the
  repository does not hold it, and without it LPIPS reports NaN, with one
  warning per process, and the summary skips all-NaN metrics.
"""
from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

log = logging.getLogger(__name__)


def psnr(pred: np.ndarray, gt: np.ndarray, mask: Optional[np.ndarray] = None) -> float:
    """-10 log10(mse) (metrics.py:27). mask: boolean array of pixels to EXCLUDE."""
    if mask is not None:
        mse = np.mean((pred[~mask] - gt[~mask]) ** 2)
    else:
        mse = np.mean((pred - gt) ** 2)
    return float(-10.0 * np.log(mse) / np.log(10.0))


def ssim(pred: np.ndarray, gt: np.ndarray, data_range: float = 2.0,
         win_size: int = 7, K1: float = 0.01, K2: float = 0.03) -> float:
    """Mean SSIM over channels, skimage-default-compatible (metrics.py:43)."""
    from scipy.ndimage import uniform_filter

    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 2:
        pred, gt = pred[..., None], gt[..., None]
    n = win_size * win_size
    cov_norm = n / (n - 1.0)
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    pad = (win_size - 1) // 2

    def filt(x):
        return uniform_filter(x, size=win_size, mode="reflect")

    vals = []
    for c in range(pred.shape[-1]):
        X, Y = pred[..., c], gt[..., c]
        ux, uy = filt(X), filt(Y)
        uxx, uyy, uxy = filt(X * X), filt(Y * Y), filt(X * Y)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
        B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
        S = (A1 * A2) / (B1 * B2)
        vals.append(S[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))


_lpips_warned = False


def lpips_vgg(pred: np.ndarray, gt: np.ndarray, device) -> Optional[float]:
    """LPIPS(VGG) on `device` (metrics.py:84); None, with one warning per
    process, where the VGG weights cannot be read."""
    global _lpips_warned
    from .lpips import lpips_distance
    try:
        return lpips_distance(pred, gt, device)
    except (OSError, KeyError, ValueError) as err:
        if not _lpips_warned:
            log.warning("LPIPS unavailable (%s); reporting NaN for LPIPS.", err)
            _lpips_warned = True
        return None


class EvalTools:
    """Per-image metrics with the reference's preprocessing (metrics.py:109):
    a mask zeroes the excluded pixels; without one, a centre crop to 80 %.
    `get_metrics(return_full=True)` adds each metric of the whole,
    unmasked image as `<metric>_Full`."""

    support_metrics = ("PSNR", "SSIM", "LPIPS")

    def __init__(self, device):
        self.device = device          # where LPIPS runs: "cuda" or "cpu"

    def set_inputs(self, pred_img, gt_img, img_mask=None):
        self.full_pred, self.full_gt = pred_img, gt_img
        self.img_mask = img_mask
        if img_mask is not None:
            self.proc_pred = pred_img.copy()
            self.proc_gt = gt_img.copy()
            self.proc_pred[img_mask] = 0.0
            self.proc_gt[img_mask] = 0.0
        else:
            H_crop, W_crop = np.array(pred_img.shape[:2]) // 10
            self.proc_pred = pred_img[H_crop:-H_crop, W_crop:-W_crop]
            self.proc_gt = gt_img[H_crop:-H_crop, W_crop:-W_crop]

    def _compute(self, metric, pred, gt, use_mask):
        if metric == "PSNR":
            return psnr(pred, gt, self.img_mask if use_mask else None)
        if metric == "SSIM":
            return ssim(pred, gt)
        if metric == "LPIPS":
            v = lpips_vgg(pred, gt, self.device)
            return float("nan") if v is None else v
        raise ValueError(metric)

    def get_metrics(self, metrics=None, return_full=False) -> "OrderedDict[str, float]":
        out = OrderedDict()
        for metric in metrics or self.support_metrics:
            if metric not in self.support_metrics:
                raise ValueError(f"unknown metric {metric}")
            out[metric] = self._compute(metric, self.proc_pred, self.proc_gt,
                                        use_mask=self.img_mask is not None)
            if return_full:
                out[f"{metric}_Full"] = self._compute(metric, self.full_pred, self.full_gt,
                                                      use_mask=False)
        return out


def summarize_metrics(metrics: Dict, out_dir: Optional[str], ep=None) -> Dict:
    """Per-view -> per-scene -> per-dataset aggregation, appended to
    `0results_{dataset}.txt` in out_dir (metrics.py:154)."""
    head_info = "" if ep is None else f" at Epoch [{ep}]"

    dataset_metrics: Dict = {}
    for dataname, raw_metrics in metrics.items():
        dataset_metrics[dataname] = {}
        all_msgs = [f"------------ {dataname.upper()} Nearest 3{head_info} ------------"]
        cur_scene = ""
        scene_metrics: Dict = {}
        for view_id, view_metrics in raw_metrics.items():
            if view_id.split("_")[0] != cur_scene:
                if cur_scene != "":
                    scene_info = f"====> scene: {cur_scene},"
                    for k, v in scene_metrics.items():
                        scene_info += f" {k}: {float(np.array(v).mean())},"
                    all_msgs.append(scene_info)
                else:
                    dataset_metrics[dataname] = OrderedDict(
                        {k: [] for k in view_metrics.keys()})
                cur_scene = view_id.split("_")[0]
                scene_metrics = {k: [] for k in view_metrics.keys()}
            view_info = f"==> view: {view_id},"
            for k, v in view_metrics.items():
                view_info += f" {k}: {float(v)},"
                scene_metrics[k].append(v)
                dataset_metrics[dataname][k].append(v)
            all_msgs.append(view_info)
        data_info = f"======> {dataname.upper()}{head_info},"
        for k, v in dataset_metrics[dataname].items():
            data_info += f" {k}: {float(np.array(v).mean())},"
        all_msgs.append(data_info)
        if out_dir is not None:
            with open(os.path.join(out_dir, f"0results_{dataname}.txt"), "a+") as f:
                f.write("\n".join(all_msgs) + "\n")
    return dataset_metrics
