"""Own-data COLMAP scenes (counterpart of matchnerf_tpu/data/llff.py's
`gen_colmap_pairs` and `COLMAPDataset`; datasets/colmap.py of the
reference), on the LLFF loader's `_LLFFBase`: poses_bounds.npy metadata
from LLFF's imgs2poses, no pose centring (relative coordinates), scale
0.47, auto-generated pairs ranked by distance to the centroid camera with
every 6th as a test view, near/far by `nf_mode`.
"""
from __future__ import annotations

import os
from glob import glob

import numpy as np

from .common import sort_nearest_views
from .llff import _LLFFBase


def gen_colmap_pairs(root_dir, n_select=20, n_interval=6):
    """Pairs of every scene under root_dir (llff.py:167): views ranked by
    distance to the centroid camera; every `n_interval`-th of the top
    `n_select` is a test view. A scene of at most 3 images takes views
    [2, 1, 0] as sources and view 0 as the target."""
    pairs = {}
    for subdir in glob(os.path.join(root_dir, "*/")):
        scene = os.path.basename(subdir.strip("/"))
        meta = os.path.join(subdir, "poses_bounds.npy")
        if not os.path.isfile(meta):
            raise FileNotFoundError(f"Please run COLMAP for {subdir} first "
                                    "(imgs2poses from the LLFF project).")
        raw = np.load(meta)[:, :15].reshape(-1, 3, 5)
        n_images = raw.shape[0]
        if n_images <= 3:
            pairs[f"{scene}_test"] = np.array([0])
            pairs[f"{scene}_val"] = np.array([0])
            pairs[f"{scene}_train"] = np.array([2, 1, 0])
            continue
        n_sel = min(n_images, int(n_select))
        n_int = min(n_images, int(n_interval))
        poses = np.concatenate([raw[..., 1:2], -raw[..., :1], raw[..., 2:4]], -1)
        ref_position = np.mean(poses[..., 3], axis=0, keepdims=True)
        dist = np.sum(np.abs(poses[..., 3] - ref_position), axis=-1)
        pair_idx = np.argsort(dist)[:n_sel]
        pairs[f"{scene}_test"] = pair_idx[::n_int]
        pairs[f"{scene}_val"] = pair_idx[::n_int]
        pairs[f"{scene}_train"] = np.delete(pair_idx, range(0, n_sel, n_int))
    return pairs


class COLMAPDataset(_LLFFBase):
    """The test split of own-data scenes (llff.py:197); test_views_method
    "fixed" keeps one anchor target per scene (video rendering)."""

    center = False                           # relative coordinates (colmap.py:95)
    scale_mult = 0.47058824                  # colmap.py:102

    def __init__(self, root_dir, split, n_views=3, img_wh=None, max_len=-1,
                 scene_list=None, test_views_method="nearest", nf_mode="avg", **kwargs):
        if split != "test":
            raise ValueError('Only support "test" split for COLMAP dataset!')
        self.root_dir = root_dir
        self.n_views = n_views
        self.img_wh = img_wh
        self.max_len = max_len
        self.nf_mode = nf_mode
        self._init_dicts()

        if scene_list is None:
            scene_list = sorted(x for x in os.listdir(root_dir)
                                if os.path.isdir(os.path.join(root_dir, x)))
        pairs = gen_colmap_pairs(root_dir)
        if test_views_method == "fixed":
            for k in pairs:
                if k.endswith("_val"):
                    pairs[k] = pairs[k][:1]

        for scene in scene_list:
            scene_dir = os.path.join(root_dir, scene)
            train_views = list(pairs[f"{scene}_train"])
            test_views = list(pairs[f"{scene}_val"])
            self._scene_camera_info(scene, scene_dir, [*train_views, *test_views])
            for target_view in test_views:
                src = sort_nearest_views(self.cam2worlds, train_views, target_view,
                                         scene=scene, method=test_views_method)
                self.metas.append((scene, target_view, src, train_views))

    def get_name(self):
        return "colmap"
