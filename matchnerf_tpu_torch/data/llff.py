"""LLFF Real Forward-Facing test set and IBRNet training set (counterpart of
matchnerf_tpu/data/llff.py's `_LLFFBase`, `LLFFDataset` and
`IBRNetDataset`; datasets/llff.py and datasets/ibrnet.py of the
reference), and the camera info and sample assembly that the COLMAP loader
(`data/colmap.py`) shares with them.

poses_bounds.npy metadata: poses re-centred at their average pose and
scaled so the nearest depth is ~1/0.75, per-view near/far averaged over the
sample's views (`nf_mode` "avg", a class attribute: the config's key does
not reach it, as in the JAX package). Eval splits from `pairs.th`
(`{scene}_train` / `{scene}_val`, eval_mode "mvsnerf") or every 8th image
held out (eval_mode "gpnr"). LLFF samples carry `c2ws_all`, the train
views' camera-to-world, for the spiral video path.

IBRNet ("ibrnet", llff.py:128): a two-level tree `root/<group>/<scene>/`
of poses_bounds.npy scenes, the scene named `<group>_<scene>`. Split
"train" makes every image a target, "val" image 0 only; the candidates
are the scene's other images by distance. A train sample draws its 3
sources among the nearest 6 (`np.sort(rng.permutation(6)[:3])`, one draw
per `__getitem__` from the dataset's own `np.random.default_rng(0)`, so
the draws follow the order samples are read in); a val sample takes the
nearest 3. Its samples carry no `c2ws_all`.
"""
from __future__ import annotations

import os
from glob import glob

import numpy as np

from .common import (MVSDatasetBase, list_all_images, llff_intrinsic, load_images,
                     load_llff_poses, load_pairs_file, make_near_fars, sort_nearest_views)
from .dtu import _META_DIR


class _LLFFBase(MVSDatasetBase):
    """Camera info and sample assembly of poses_bounds.npy scenes
    (llff.py:29)."""

    nf_mode = "avg"
    center = True
    scale_mult = 0.75

    def _init_dicts(self):
        self.metas = []
        self.intrinsics, self.world2cams, self.cam2worlds = {}, {}, {}
        self.near_fars, self.imgs_paths, self.scene_dirs = {}, {}, {}

    def num_samples(self):
        return len(self.metas)

    def _scene_camera_info(self, scene, scene_dir, id_list):
        poses, bounds, hwf = load_llff_poses(
            os.path.join(scene_dir, "poses_bounds.npy"),
            center=self.center, scale_mult=self.scale_mult)
        images_list = list_all_images(os.path.join(scene_dir, "images"))
        for vid in id_list:
            key = f"{scene}_{vid}"
            self.intrinsics[key] = llff_intrinsic(hwf[vid], self.img_wh)
            c2w = np.eye(4)
            c2w[:3] = poses[vid]
            self.cam2worlds[key] = c2w
            # inverted in f32, as the JAX loader does (llff.py:47)
            self.world2cams[key] = np.linalg.inv(c2w.astype(np.float32))
            self.near_fars[key] = bounds[vid]
            self.imgs_paths[key] = images_list[vid]
            self.scene_dirs[scene] = scene_dir

    def _assemble(self, scene, view_ids, train_views=None):
        img_wh = np.array(self.img_wh).astype("int")
        keys = [f"{scene}_{vid}" for vid in view_ids]
        imgs = load_images([os.path.join(self.scene_dirs[scene], "images",
                                         self.imgs_paths[k]) for k in keys], img_wh)
        sample = {
            "images": np.stack(imgs).astype(np.float32),
            "extrinsics": np.stack([self.world2cams[k] for k in keys]).astype(np.float32),
            "intrinsics": np.stack([self.intrinsics[k] for k in keys]).astype(np.float32),
            "near_fars": make_near_fars([self.near_fars[k] for k in keys], len(view_ids),
                                        self.nf_mode),
            "view_ids": np.array([int(v) for v in view_ids]),
            "scene": scene,
            "img_wh": img_wh,
        }
        if train_views is not None:
            sample["c2ws_all"] = np.stack([self.cam2worlds[f"{scene}_{x}"]
                                           for x in train_views]).astype(np.float32)
        return sample

    def __getitem__(self, idx):
        scene, target_view, src_views, train_views = self.metas[idx]
        view_ids = [src_views[i] for i in range(self.n_views)] + [target_view]
        return self._assemble(scene, view_ids, train_views)


class LLFFDataset(_LLFFBase):
    """The test split of LLFF scenes (llff.py:82)."""

    test_hold_out = 8

    def __init__(self, root_dir, split, n_views=3, img_wh=None, max_len=-1,
                 scene_list=None, test_views_method="nearest", eval_mode="mvsnerf",
                 meta_dir=None, **kwargs):
        if split != "test":
            raise ValueError('Only support "test" split for LLFF dataset!')
        if eval_mode not in ("mvsnerf", "gpnr"):
            raise ValueError(f"LLFF eval_mode {eval_mode!r}: mvsnerf or gpnr")
        self.root_dir = root_dir
        self.n_views = n_views
        self.img_wh = img_wh
        self.max_len = max_len
        self.eval_mode = eval_mode
        self._init_dicts()

        if scene_list is None:
            scene_list = sorted(x for x in os.listdir(root_dir)
                                if os.path.isdir(os.path.join(root_dir, x)))
        pairs = (load_pairs_file(os.path.join(meta_dir or _META_DIR, "pairs.th"))
                 if eval_mode == "mvsnerf" else None)
        for scene in scene_list:
            scene_dir = os.path.join(root_dir, scene)
            if eval_mode == "mvsnerf":
                train_views = list(pairs[f"{scene}_train"])
                test_views = list(pairs[f"{scene}_val"])
            else:
                n = len(list_all_images(os.path.join(scene_dir, "images")))
                test_views = list(range(0, n, self.test_hold_out))
                train_views = [x for x in range(n) if x not in test_views]
            self._scene_camera_info(scene, scene_dir, [*train_views, *test_views])
            for target_view in test_views:
                src = sort_nearest_views(self.cam2worlds, train_views, target_view,
                                         scene=scene, method=test_views_method)
                self.metas.append((scene, target_view, src, train_views))

    def get_name(self):
        return "llff"


class IBRNetDataset(_LLFFBase):
    """The IBRNet training and validation scenes (llff.py:128)."""

    def __init__(self, root_dir, split, n_views=3, img_wh=None, max_len=-1,
                 test_views_method="nearest", rng=None, **kwargs):
        if split not in ("train", "val"):
            raise ValueError('Only support "train" and "val" split for IBRNet dataset!')
        self.root_dir = root_dir
        self.split = split
        self.n_views = n_views
        self.img_wh = img_wh
        self.max_len = max_len
        self.rng = rng or np.random.default_rng(0)
        self._init_dicts()
        for subdir in sorted(glob(os.path.join(root_dir, "*/"))):
            for scene_dir in sorted(glob(os.path.join(subdir, "*/"))):
                scene = "_".join(scene_dir.strip("/").split("/")[-2:])
                n = np.load(os.path.join(scene_dir, "poses_bounds.npy")).shape[0]
                self._scene_camera_info(scene, scene_dir, list(range(n)))
                for target_view in (range(n) if split == "train" else [0]):
                    train_views = [x for x in range(n) if x != target_view]
                    src = sort_nearest_views(self.cam2worlds, train_views, target_view,
                                             scene=scene, method=test_views_method)
                    self.metas.append((scene, target_view, src))

    def get_name(self):
        return "ibrnet"

    def _view_ids(self, idx):
        _, target_view, src_views = self.metas[idx]
        if self.split == "train":
            # 3 of the nearest 6, in rank order (ibrnet.py:204-205)
            ids = np.sort(self.rng.permutation(self.n_views + 3)[: self.n_views])
            return [src_views[i] for i in ids] + [target_view]
        return src_views[: self.n_views] + [target_view]

    def skip_sample(self, idx):
        """The draws of sample idx without loading it (a sharded loader's
        other shards)."""
        self._view_ids(idx)

    def __getitem__(self, idx):
        return self._assemble(self.metas[idx][0], self._view_ids(idx))
