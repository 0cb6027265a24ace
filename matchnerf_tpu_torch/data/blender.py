"""NeRF-synthetic (Blender) test set (counterpart of
matchnerf_tpu/data/blender.py::BlenderDataset; datasets/blender.py of the
reference).

transforms_{train,test}.json cameras flipped from Blender's axes to
OpenCV's (`BLENDER2OPENCV`), one focal from `camera_angle_x` (for an
800-pixel-wide render, scaled to img_wh), near/far [2, 6] for every view,
and the RGBA images composited onto white. eval_mode "mvsnerf" takes the
`pairs.th` view ids over transforms_train.json; "gpnr" the scene's own
train/ and test/ images, whose `view_ids` are the integers of their names.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .common import (BLENDER2OPENCV, MVSDatasetBase, load_images, load_pairs_file,
                     sort_nearest_views)
from .dtu import _META_DIR


def _frame_index(vid) -> int:
    """A view id's frame: an integer id, or the number after the last '_'
    of a gpnr name such as "test_7"."""
    return vid if isinstance(vid, int) else int(str(vid).split("_")[-1])


class BlenderDataset(MVSDatasetBase):
    def __init__(self, root_dir, split, n_views=3, img_wh=None, max_len=-1,
                 scene_list=None, test_views_method="nearest", eval_mode="mvsnerf",
                 meta_dir=None, **kwargs):
        if split != "test":
            raise ValueError('Only support "test" split for blender dataset!')
        if eval_mode not in ("mvsnerf", "gpnr"):
            raise ValueError(f"Blender eval_mode {eval_mode!r}: mvsnerf or gpnr")
        if img_wh is not None and (img_wh[0] % 32 or img_wh[1] % 32):
            raise ValueError(f"img_wh {tuple(img_wh)} must both be multiples of 32")
        self.root_dir = root_dir
        self.n_views = n_views
        self.img_wh = img_wh
        self.max_len = max_len
        self.eval_mode = eval_mode
        self.metas = []
        self.intrinsics, self.world2cams, self.cam2worlds = {}, {}, {}
        self.near_fars, self.imgs_paths = {}, {}

        if scene_list is None:
            scene_list = sorted(x for x in os.listdir(root_dir)
                                if os.path.isdir(os.path.join(root_dir, x)))
        pairs = load_pairs_file(os.path.join(meta_dir or _META_DIR, "pairs.th"))
        for scene in scene_list:
            self._add_scene(scene, pairs, test_views_method)

    def get_name(self):
        return "blender"

    def num_samples(self):
        return len(self.metas)

    def _camera_info(self, scene, id_list, meta_filepath):
        with open(meta_filepath) as f:
            meta = json.load(f)
        w, h = self.img_wh
        focal = 0.5 * 800.0 / np.tan(0.5 * meta["camera_angle_x"]) * w / 800.0
        intr = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
        for vid in id_list:
            key = f"{scene}_{vid}"
            frame = meta["frames"][_frame_index(vid)]
            c2w = np.array(frame["transform_matrix"]) @ BLENDER2OPENCV
            self.intrinsics[key] = intr
            self.cam2worlds[key] = c2w
            self.world2cams[key] = np.linalg.inv(c2w)
            self.near_fars[key] = [2.0, 6.0]
            self.imgs_paths[key] = f"{frame['file_path']}.png"

    def _add_scene(self, scene, pairs, method):
        scene_dir = os.path.join(self.root_dir, scene)
        if self.eval_mode == "mvsnerf":
            train_views = list(pairs[f"{scene}_train"])
            test_views = list(pairs[f"{scene}_val"])
            self._camera_info(scene, train_views + test_views,
                              os.path.join(scene_dir, "transforms_train.json"))
        else:
            def views_of(split_name):
                d = os.path.join(scene_dir, split_name)
                idxs = sorted({int(x.split(".")[0].split("_")[-1])
                               for x in os.listdir(d) if x.endswith("png")})
                return [f"{split_name}_{i}" for i in idxs]
            train_views, test_views = views_of("train"), views_of("test")
            self._camera_info(scene, train_views,
                              os.path.join(scene_dir, "transforms_train.json"))
            self._camera_info(scene, test_views,
                              os.path.join(scene_dir, "transforms_test.json"))
        for target_view in test_views:
            src = sort_nearest_views(self.cam2worlds, train_views, target_view,
                                     scene=scene, method=method)
            self.metas.append((scene, target_view, src))

    def __getitem__(self, idx):
        scene, target_view, src_views = self.metas[idx]
        view_ids = [src_views[i] for i in range(self.n_views)] + [target_view]
        img_wh = np.array(self.img_wh).astype("int")
        keys = [f"{scene}_{vid}" for vid in view_ids]
        imgs = load_images([os.path.join(self.root_dir, scene, self.imgs_paths[k])
                            for k in keys], img_wh, blend_alpha_white=True)
        return {
            "images": np.stack(imgs).astype(np.float32),
            "extrinsics": np.stack([self.world2cams[k] for k in keys]).astype(np.float32),
            "intrinsics": np.stack([self.intrinsics[k] for k in keys]).astype(np.float32),
            "near_fars": np.stack([self.near_fars[k] for k in keys]).astype(np.float32),
            "view_ids": np.array([_frame_index(v) for v in view_ids]),
            "scene": scene,
            "img_wh": img_wh,
        }
