"""Offline re-scoring of saved prediction / ground-truth pairs (counterpart
of matchnerf_tpu/score_preds.py; misc/score_preds.py of the reference).

    python -m matchnerf_tpu_torch.score_preds --pred_folder=DIR [--gt_folder=DIR] [--cpu]

Scans DIR for the `*_pred.png` / `*_gt.png` pairs that the eval entry
writes with `separate_save` (configs/test_tnt.yaml), scores each pair
with the 80 % centre crop of `EvalTools` (PSNR, SSIM, LPIPS), writes
`0scores.json` in the prediction folder under the JAX package's keys
(scene -> [{"view_idx", "src_idx", "metrics"}]) and prints each metric's
mean over the finite values. The PNGs decode with `data/png.py` (no PIL).
LPIPS runs on the card unless given `--cpu`; without a card and without
`--cpu` the entry exits with an error.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .data.png import read_png
from .metrics import EvalTools


def list_pairs(pred_dir: str, gt_dir: str):
    """(prediction, ground truth) paths of every `*_pred.png` in pred_dir
    whose `*_gt.png` is in gt_dir, in name order."""
    pairs = []
    for f in sorted(os.listdir(pred_dir)):
        if not f.endswith("_pred.png"):
            continue
        gt_path = os.path.join(gt_dir, f[: -len("_pred.png")] + "_gt.png")
        if os.path.exists(gt_path):
            pairs.append((os.path.join(pred_dir, f), gt_path))
    return pairs


def read_rgb(path: str) -> np.ndarray:
    """[H,W,3] f32 in [0,1]: a greyscale PNG repeated, an alpha channel
    dropped (PIL's convert("RGB"))."""
    img = read_png(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3].astype(np.float32) / 255.0


def view_ids(pred_path: str):
    """(scene, view index, source indices) from a name such as
    `scan1_view24_src20_21_22_pred.png`; -1 and [] where it does not parse."""
    parts = os.path.basename(pred_path).split("_")
    try:
        return parts[0], int(parts[1][4:]), [int(parts[2][3:]), int(parts[3]), int(parts[4])]
    except (IndexError, ValueError):
        return parts[0], -1, []


def score_folder(pred_folder: str, gt_folder: str = None, device="cuda"):
    """Score every pair (LPIPS on `device`), write `0scores.json` in
    pred_folder; returns (scores by scene, each metric's values)."""
    eval_tools = EvalTools(device)
    scores, values = {}, {}
    for pred_path, gt_path in list_pairs(pred_folder, gt_folder or pred_folder):
        eval_tools.set_inputs(read_rgb(pred_path), read_rgb(gt_path))
        cur = eval_tools.get_metrics(return_full=False)
        for m, v in cur.items():
            values.setdefault(m, []).append(v)
        scene, view_idx, src_idx = view_ids(pred_path)
        scores.setdefault(scene, []).append(
            {"view_idx": view_idx, "src_idx": src_idx,
             "metrics": {k: float(v) for k, v in cur.items()}})
    with open(os.path.join(pred_folder, "0scores.json"), "w") as f:
        json.dump(scores, f)
    return scores, values


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--pred_folder", type=str, required=True,
                        help="folder with the *_pred.png images")
    parser.add_argument("--gt_folder", type=str, default=None,
                        help="folder with the *_gt.png images (default: pred_folder)")
    parser.add_argument("--cpu", action="store_true", help="compute LPIPS on the CPU")
    args = parser.parse_args(argv)
    import torch
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("score_preds: no CUDA device for LPIPS; pass --cpu to score on the CPU")
    _, values = score_folder(args.pred_folder, args.gt_folder, "cpu" if args.cpu else "cuda")
    print(args.pred_folder)
    for m, vals in values.items():
        finite = [v for v in vals if np.isfinite(v)]
        print(m, float(np.mean(finite)) if finite else "n/a (no finite values)")


if __name__ == "__main__":
    main()
