"""Shared host-side data helpers (counterpart of matchnerf_tpu/data/common.py,
the parts the COLMAP loader uses: no pose re-centring, no alpha blending,
no per-view near/far). numpy only; PIL is imported inside
`load_image`, the one function that decodes images.

A sample is a dict of numpy arrays, target view LAST:

    images      (V+1, H, W, 3) float32 in [0,1]
    extrinsics  (V+1, 4, 4)    world-to-camera
    intrinsics  (V+1, 3, 3)
    near_fars   (V+1, 2)
    view_ids    (V+1,) int
    scene       str
    img_wh      (2,) int
    [c2ws_all]  (N, 4, 4)      camera-to-world of every train view (spiral paths)
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

IMAGE_EXTENSIONS = (".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm",
                    ".PPM", ".bmp", ".BMP", ".tif", ".TIF", ".tiff", ".TIFF")

BLENDER2OPENCV = np.array([[1, 0, 0, 0], [0, -1, 0, 0],
                           [0, 0, -1, 0], [0, 0, 0, 1]], np.float64)


def list_all_images(root_dir: str) -> List[str]:
    """Sorted image filenames in a directory (common.py:35)."""
    return sorted(f for f in os.listdir(root_dir) if f.endswith(IMAGE_EXTENSIONS))


def load_image(path: str, img_wh) -> np.ndarray:
    """Load an image, LANCZOS-resize it to img_wh -> [H,W,3] float32 in
    [0,1] (common.py:40)."""
    from PIL import Image
    img = Image.open(path)
    img = img.resize(tuple(int(x) for x in img_wh), Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return arr[..., :3]


def sort_nearest_views(cam2worlds: Dict, train_views, target_view,
                       scene: Optional[str] = None, method: str = "nearest"):
    """Candidate source views ranked by |camera centre - target centre|_1
    ("nearest"), or as given ("fixed") (common.py:88)."""
    def key(v):
        return f"{scene}_{v}" if scene is not None else v

    if method == "nearest":
        pos = np.stack([np.asarray(cam2worlds[key(x)]) for x in train_views])[:, :3, 3]
        tgt = np.asarray(cam2worlds[key(target_view)])[:3, 3]
        dis = np.sum(np.abs(pos - tgt), axis=-1)
        return [train_views[i] for i in np.argsort(dis)]
    if method == "fixed":
        return list(train_views)
    raise ValueError(f"Unknown test_views_method [{method}]")


def load_llff_poses(meta_filepath: str, scale_mult: float):
    """poses_bounds.npy -> (poses [N,3,4] c2w OpenCV, bounds [N,2], hwf
    [N,3]), scaled so the nearest depth is ~1/scale_mult (common.py:130,
    without re-centring: the COLMAP loader keeps relative coordinates)."""
    poses_bounds = np.load(meta_filepath)
    raw = poses_bounds[:, :15].copy().reshape(-1, 3, 5)
    hwf = raw[:, :, 4].copy()
    poses = np.concatenate([raw[..., 1:2], -raw[..., :1], raw[..., 2:4]], -1)
    poses = poses @ BLENDER2OPENCV
    bounds = poses_bounds[:, -2:].copy()
    scale_factor = bounds.min() * scale_mult
    bounds = bounds / scale_factor
    poses[..., 3] /= scale_factor
    return poses, bounds, hwf


def llff_intrinsic(hwf_row: np.ndarray, img_wh) -> np.ndarray:
    """Pinhole intrinsics of an LLFF (h, w, focal) row at img_wh (common.py:148)."""
    raw_h, raw_w, focal = hwf_row
    w, h = img_wh
    return np.array([[focal * w / raw_w, 0, w / 2],
                     [0, focal * h / raw_h, h / 2],
                     [0, 0, 1]], np.float64)


def make_near_fars(near_fars: List, n_views: int, nf_mode: str) -> np.ndarray:
    """The sample's (V+1, 2) near/fars (common.py:167): avg, the mean over
    views; minmax, [0.8 min, 1.2 max] of them all."""
    nf = np.stack([np.asarray(x, np.float64) for x in near_fars])
    if nf_mode == "avg":
        return np.repeat(nf.mean(axis=0, keepdims=True), n_views, axis=0).astype(np.float32)
    if nf_mode == "minmax":
        row = np.array([nf.min() * 0.8, nf.max() * 1.2])
        return np.repeat(row[None], n_views, axis=0).astype(np.float32)
    raise ValueError(f"Unknown near far mode {nf_mode}")


class MVSDatasetBase:
    """Minimal dataset protocol: __len__, __getitem__, get_name()."""

    max_len: int = -1

    def get_name(self) -> str:
        raise NotImplementedError

    def num_samples(self) -> int:
        raise NotImplementedError

    def __len__(self):
        n = self.num_samples()
        return n if self.max_len <= 0 else min(self.max_len, n)
