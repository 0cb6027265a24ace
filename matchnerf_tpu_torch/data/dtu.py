"""DTU (MVSNet-preprocessed) dataset (counterpart of
matchnerf_tpu/data/dtu.py::DTUDataset).

Train and val metas come from `<meta_dir>/dtu_meta/view_pairs.txt`: each
reference view with its score-ranked source views, over the 7 light
conditions for train and light 3 (reference view 24 only) for val. The test
split takes `<meta_dir>/pairs.th`'s 16 train and 4 test views of every scan
of `dtu_meta/val_all.txt`, sources ranked nearest. Poses are scaled by
1/200 and intrinsics by 4; near = depth_min / 200, far = near + 192 *
interval / 200. On the train split the sources are a sorted random choice
of n_views among the top n_views + n_add_train_views (`permute_train_src`),
drawn from the dataset's numpy generator in the order the samples are read.
Val and test samples carry the target's ground-truth depth (1/200 scale,
the 1200x1600 map halved by nearest sampling and cropped to 512x640) for
the evaluation mask. A sample's images decode together and, at another img_wh,
resize with PIL's BILINEAR filter (`common.load_images`, no PIL).
"""
from __future__ import annotations

import os

import numpy as np

from .common import (MVSDatasetBase, load_images, load_pairs_file, read_mvsnet_cam_file,
                     read_pfm, resize_nearest, sort_nearest_views)

_META_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")


class DTUDataset(MVSDatasetBase):
    def __init__(self, root_dir, split, n_views=3, img_wh=None, downSample=1.0,
                 max_len=-1, test_views_method="nearest", n_add_train_views=2,
                 meta_dir=None, rng=None, **kwargs):
        if split not in ("train", "val", "test"):
            raise ValueError(f"DTU split {split!r}: train, val or test")
        if img_wh is not None and (img_wh[0] % 32 or img_wh[1] % 32):
            raise ValueError(f"img_wh {tuple(img_wh)} must both be multiples of 32")
        self.root_dir = root_dir
        self.split = split
        self.n_views = n_views
        self.img_wh = img_wh
        self.downSample = downSample
        self.scale_factor = 1.0 / 200
        self.max_len = max_len
        self.val_light_idx = 3
        self.val_view_idx = 24
        self.n_add_train_views = n_add_train_views
        self.permute_train_src = True
        self.rng = rng or np.random.default_rng(0)
        meta_dir = meta_dir or _META_DIR

        if split in ("train", "val"):
            self.metas, id_list = self._build_train_metas(
                os.path.join(meta_dir, "dtu_meta", "train_all.txt"),
                os.path.join(meta_dir, "dtu_meta", "view_pairs.txt"))
        else:
            pairs = load_pairs_file(os.path.join(meta_dir, "pairs.th"))
            train_views, test_views = list(pairs["dtu_train"]), list(pairs["dtu_test"])
            id_list = [*train_views, *test_views]
        self._build_camera_info(np.unique(id_list))
        if split == "test":
            self.metas = self._build_test_metas(
                os.path.join(meta_dir, "dtu_meta", "val_all.txt"), train_views, test_views,
                method=test_views_method)

    def get_name(self):
        return "dtu"

    def num_samples(self):
        return len(self.metas)

    @staticmethod
    def _scans(scene_list_file):
        with open(scene_list_file) as f:
            return [line.rstrip() for line in f if line.strip()]

    def _build_train_metas(self, scene_list_file, view_pairs_file):
        light_idxs = [self.val_light_idx] if self.split != "train" else range(7)
        pairs = {}                     # reference view -> score-ranked sources
        with open(view_pairs_file) as f:
            for _ in range(int(f.readline())):
                ref_view = int(f.readline().rstrip())
                pairs[ref_view] = [int(x) for x in f.readline().rstrip().split()[1::2]]
        metas, id_list = [], []
        for scan in self._scans(scene_list_file):
            for ref_view, src_views in pairs.items():
                for light_idx in light_idxs:
                    if self.split == "val" and ref_view != self.val_view_idx:
                        continue
                    metas.append((scan, light_idx, ref_view, src_views))
                    id_list.append([ref_view] + src_views)
        return metas, id_list

    def _build_test_metas(self, scene_list_file, train_views, test_views, method):
        return [(scan, 3, target_view,
                 sort_nearest_views(self.cam2worlds, train_views, target_view, method=method))
                for scan in self._scans(scene_list_file) for target_view in test_views]

    def _build_camera_info(self, id_list):
        self.intrinsics, self.world2cams, self.cam2worlds, self.near_fars = {}, {}, {}, {}
        for vid in id_list:
            intrinsic, extrinsic, depth_tokens = read_mvsnet_cam_file(
                os.path.join(self.root_dir, f"Cameras/train/{vid:08d}_cam.txt"))
            intrinsic[:2] *= 4 * self.downSample
            extrinsic[:3, 3] *= self.scale_factor
            depth_min = depth_tokens[0] * self.scale_factor
            depth_max = depth_min + depth_tokens[1] * 192 * self.scale_factor
            self.intrinsics[vid] = intrinsic
            self.world2cams[vid] = extrinsic
            self.cam2worlds[vid] = np.linalg.inv(extrinsic)
            self.near_fars[vid] = [depth_min, depth_max]

    def _read_depth(self, filename):
        """Ground-truth depth: the pfm halved by nearest sampling, cropped to
        512x640, optionally downsampled (dtu.py:123)."""
        depth = np.array(read_pfm(filename)[0], dtype=np.float32)
        depth = resize_nearest(depth, 0.5)[44:556, 80:720]
        if self.downSample != 1.0:
            depth = resize_nearest(depth, self.downSample)
        return depth

    def _view_ids(self, idx):
        """Sample idx's source views and target (the training split draws
        its sources from the dataset's generator)."""
        _, _, target_view, src_views = self.metas[idx]
        if self.permute_train_src and self.split == "train":
            ids = np.sort(self.rng.permutation(
                self.n_views + self.n_add_train_views)[: self.n_views])
            return [src_views[i] for i in ids] + [target_view]
        return [src_views[i] for i in range(self.n_views)] + [target_view]

    def skip_sample(self, idx):
        """The draws of sample idx without loading it (a sharded loader's
        other shards)."""
        self._view_ids(idx)

    def __getitem__(self, idx):
        scan, light_idx, target_view, _ = self.metas[idx]
        view_ids = self._view_ids(idx)

        img_wh = np.round(np.array(self.img_wh) * self.downSample).astype("int")
        imgs = load_images([os.path.join(
            self.root_dir, f"Rectified/{scan}_train/rect_{vid + 1:03d}_{light_idx}_r5000.png")
            for vid in view_ids], img_wh, resample="bilinear")
        intrinsics, w2cs, near_fars = [], [], []
        depth = None
        for vid in view_ids:
            intrinsics.append(self.intrinsics[vid])
            w2cs.append(self.world2cams[vid])
            near_fars.append(self.near_fars[vid])
            if self.split in ("test", "val") and vid == target_view:
                depth_filename = os.path.join(self.root_dir,
                                              f"Depths/{scan}/depth_map_{vid:04d}.pfm")
                if not os.path.exists(depth_filename):
                    raise FileNotFoundError(f"{depth_filename}: evaluation needs the depth")
                depth = self._read_depth(depth_filename) * self.scale_factor

        sample = {
            "images": np.stack(imgs).astype(np.float32),
            "extrinsics": np.stack(w2cs).astype(np.float32),
            "intrinsics": np.stack(intrinsics).astype(np.float32),
            "near_fars": np.stack(near_fars).astype(np.float32),
            "view_ids": np.array(view_ids),
            "scene": scan,
            "img_wh": img_wh,
        }
        if depth is not None:
            sample["depth"] = depth.astype(np.float32)
        return sample
