"""Own-data COLMAP scenes (counterpart of matchnerf_tpu/data/llff.py's
`gen_colmap_pairs` and `COLMAPDataset` with the parts of `_LLFFBase` it
uses; datasets/colmap.py of the reference): poses_bounds.npy metadata from
LLFF's imgs2poses, no pose centring (relative coordinates), scale 0.47,
auto-generated pairs ranked by distance to the centroid camera with every
6th as a test view, near/far by `nf_mode`. The LLFF and IBRNet datasets,
which share `_LLFFBase` in the JAX package, are not ported.
"""
from __future__ import annotations

import os
from glob import glob

import numpy as np

from .common import (MVSDatasetBase, list_all_images, llff_intrinsic, load_image,
                     load_llff_poses, make_near_fars, sort_nearest_views)


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


class COLMAPDataset(MVSDatasetBase):
    """The test split of own-data scenes (llff.py:197); test_views_method
    "fixed" keeps one anchor target per scene (video rendering)."""

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

    def num_samples(self):
        return len(self.metas)

    def _scene_camera_info(self, scene, scene_dir, id_list):
        poses, bounds, hwf = load_llff_poses(
            os.path.join(scene_dir, "poses_bounds.npy"), self.scale_mult)
        images_list = list_all_images(os.path.join(scene_dir, "images"))
        for vid in id_list:
            key = f"{scene}_{vid}"
            self.intrinsics[key] = llff_intrinsic(hwf[vid], self.img_wh)
            c2w = np.eye(4)
            c2w[:3] = poses[vid]
            self.cam2worlds[key] = c2w
            self.world2cams[key] = np.linalg.inv(c2w.astype(np.float32))
            self.near_fars[key] = bounds[vid]
            self.imgs_paths[key] = images_list[vid]
            self.scene_dirs[scene] = scene_dir

    def _init_dicts(self):
        self.metas = []
        self.intrinsics, self.world2cams, self.cam2worlds = {}, {}, {}
        self.near_fars, self.imgs_paths, self.scene_dirs = {}, {}, {}

    def _assemble(self, scene, view_ids, train_views):
        img_wh = np.array(self.img_wh).astype("int")
        imgs, intrinsics, w2cs, near_fars = [], [], [], []
        for vid in view_ids:
            key = f"{scene}_{vid}"
            imgs.append(load_image(
                os.path.join(self.scene_dirs[scene], "images", self.imgs_paths[key]), img_wh))
            intrinsics.append(self.intrinsics[key])
            w2cs.append(self.world2cams[key])
            near_fars.append(self.near_fars[key])
        sample = {
            "images": np.stack(imgs).astype(np.float32),
            "extrinsics": np.stack(w2cs).astype(np.float32),
            "intrinsics": np.stack(intrinsics).astype(np.float32),
            "near_fars": make_near_fars(near_fars, len(view_ids), self.nf_mode),
            "view_ids": np.array([int(v) for v in view_ids]),
            "scene": scene,
            "img_wh": img_wh,
            "c2ws_all": np.stack([self.cam2worlds[f"{scene}_{x}"]
                                  for x in train_views]).astype(np.float32),
        }
        return sample

    def __getitem__(self, idx):
        scene, target_view, src_views, train_views = self.metas[idx]
        view_ids = [src_views[i] for i in range(self.n_views)] + [target_view]
        return self._assemble(scene, view_ids, train_views)

