"""Tanks and Temples test set (counterpart of
matchnerf_tpu/data/tnt.py::TNTDataset; datasets/tnt.py of the reference).

MVSNet camera files `cams_1/{vid:08d}_cam.txt`, translations and depth
bounds times 500, camera-to-world inverted in f32 (tnt.py:73), intrinsics
scaled by img_wh over each image file's own size, near/far by `nf_mode`
(configs/test.yaml: minmax). Eval splits from `pairs.th`
(`TNT_{scene}_train` / `TNT_{scene}_val`, eval_mode "mvsnerf") or every 8th
image held out ("gpnr"). Samples carry `c2ws_all`. The images are
`images/{vid:08d}.jpg`, as the JAX loader names them, decoded by
`data/jpeg.py` and resized with LANCZOS by `data/resample.py` (no PIL).
"""
from __future__ import annotations

import os

import numpy as np

from .common import (MVSDatasetBase, image_size, list_all_images, load_images,
                     load_pairs_file, make_near_fars, read_mvsnet_cam_file,
                     sort_nearest_views)
from .dtu import _META_DIR


class TNTDataset(MVSDatasetBase):
    test_hold_out = 8
    scale_factor = 500.0

    def __init__(self, root_dir, split, n_views=3, img_wh=None, max_len=-1,
                 scene_list=None, test_views_method="nearest", eval_mode="mvsnerf",
                 nf_mode="avg", meta_dir=None, **kwargs):
        if split != "test":
            raise ValueError('Only support "test" split for TNT dataset!')
        if eval_mode not in ("mvsnerf", "gpnr"):
            raise ValueError(f"T&T eval_mode {eval_mode!r}: mvsnerf or gpnr")
        self.root_dir = root_dir
        self.n_views = n_views
        self.img_wh = img_wh
        self.max_len = max_len
        self.nf_mode = nf_mode
        self.eval_mode = eval_mode
        self.metas = []
        self.intrinsics, self.world2cams, self.cam2worlds = {}, {}, {}
        self.near_fars, self.imgs_paths = {}, {}

        if scene_list is None:
            scene_list = sorted(x for x in os.listdir(root_dir)
                                if os.path.isdir(os.path.join(root_dir, x)))
        pairs = (load_pairs_file(os.path.join(meta_dir or _META_DIR, "pairs.th"))
                 if eval_mode == "mvsnerf" else None)
        for scene in scene_list:
            if eval_mode == "mvsnerf":
                train_views = list(pairs[f"TNT_{scene}_train"])
                test_views = list(pairs[f"TNT_{scene}_val"])
            else:
                n = len(list_all_images(os.path.join(root_dir, scene, "images")))
                test_views = list(range(0, n, self.test_hold_out))
                train_views = [x for x in range(n) if x not in test_views]
            self._camera_info(scene, [*train_views, *test_views])
            for target_view in test_views:
                src = sort_nearest_views(self.cam2worlds, train_views, target_view,
                                         scene=scene, method=test_views_method)
                self.metas.append((scene, target_view, src, train_views))

    def get_name(self):
        return "tnt"

    def num_samples(self):
        return len(self.metas)

    def _camera_info(self, scene, id_list):
        cameras_dir = os.path.join(self.root_dir, scene, "cams_1")
        for vid in id_list:
            key = f"{scene}_{vid}"
            intr, extr, depth_tokens = read_mvsnet_cam_file(
                os.path.join(cameras_dir, f"{vid:08d}_cam.txt"))
            extr[:3, 3] *= self.scale_factor
            self.intrinsics[key] = intr
            self.world2cams[key] = extr
            self.cam2worlds[key] = np.linalg.inv(extr.astype(np.float32))
            self.near_fars[key] = np.array([depth_tokens[0] * self.scale_factor,
                                            depth_tokens[-1] * self.scale_factor])
            self.imgs_paths[key] = f"{vid:08d}.jpg"

    def __getitem__(self, idx):
        scene, target_view, src_views, train_views = self.metas[idx]
        view_ids = [src_views[i] for i in range(self.n_views)] + [target_view]
        img_wh = np.array(self.img_wh).astype("int")
        keys = [f"{scene}_{vid}" for vid in view_ids]
        paths = [os.path.join(self.root_dir, scene, "images", self.imgs_paths[k])
                 for k in keys]
        intrinsics = []
        for key, path in zip(keys, paths):
            ori_w, ori_h = image_size(path)
            intr = self.intrinsics[key].copy()
            intr[0] *= img_wh[0] / ori_w              # tnt.py:160-163
            intr[1] *= img_wh[1] / ori_h
            intrinsics.append(intr)
        return {
            "images": np.stack(load_images(paths, img_wh)).astype(np.float32),
            "extrinsics": np.stack([self.world2cams[k] for k in keys]).astype(np.float32),
            "intrinsics": np.stack(intrinsics).astype(np.float32),
            "near_fars": make_near_fars([self.near_fars[k] for k in keys], len(view_ids),
                                        self.nf_mode),
            "view_ids": np.array([int(v) for v in view_ids]),
            "scene": scene,
            "img_wh": img_wh,
            "c2ws_all": np.stack([self.cam2worlds[f"{scene}_{x}"]
                                  for x in train_views]).astype(np.float32),
        }
