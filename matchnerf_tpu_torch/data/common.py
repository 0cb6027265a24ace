"""Shared host-side data helpers (counterpart of matchnerf_tpu/data/common.py):
image loading with Blender's alpha blend onto white, the image size, PFM
and MVSNet camera files, view ranking, LLFF poses_bounds.npy with or
without re-centring, near/far modes. No PIL: PNGs decode with `data/png.py`,
JPEGs with `data/jpeg.py`, each size comes from the file's header, and
`data/resample.py` resizes as PIL's LANCZOS and BILINEAR do, all bit-equal
to PIL.

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
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from .jpeg import is_jpeg, jpeg_size, read_jpeg
from .png import png_size, read_pngs
from .resample import resize

LOAD_THREADS = 4                       # JPEG decodes and resizes of one sample at once
_pool = None
_pool_lock = threading.Lock()

IMAGE_EXTENSIONS = (".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm",
                    ".PPM", ".bmp", ".BMP", ".tif", ".TIF", ".tiff", ".TIFF")

BLENDER2OPENCV = np.array([[1, 0, 0, 0], [0, -1, 0, 0],
                           [0, 0, -1, 0], [0, 0, 0, 1]], np.float64)


def list_all_images(root_dir: str) -> List[str]:
    """Sorted image filenames in a directory (common.py:35)."""
    return sorted(f for f in os.listdir(root_dir) if f.endswith(IMAGE_EXTENSIONS))


def _load_one(path: str, png, wh, resample: str, blend_alpha_white: bool) -> np.ndarray:
    """One image of `load_images`; `png` holds a PNG's pixels, already decoded."""
    if png is not None:
        arr = png
    elif is_jpeg(path):
        arr = read_jpeg(path)
    else:
        raise ValueError(f"{path}: only PNG and JPEG images are read")
    if (arr.shape[1], arr.shape[0]) != wh:
        arr = resize(arr, wh, resample)
    arr = arr.astype(np.float32) / 255.0
    if blend_alpha_white and arr.ndim == 3 and arr.shape[-1] == 4:
        rgb, a = arr[..., :3], arr[..., 3:]
        arr = rgb * a + (1.0 - a)
    elif arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return arr[..., :3]


def _threads() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(LOAD_THREADS, thread_name_prefix="load_images")
    return _pool


def load_images(paths: Sequence[str], img_wh, resample: str = "lanczos",
                blend_alpha_white: bool = False) -> List[np.ndarray]:
    """Load images and resize each to img_wh with PIL's LANCZOS or BILINEAR
    filter -> [H,W,3] float32 in [0,1] each (common.py:40), bit-equal to
    the JAX loader's PIL path. PNGs decode in `png.read_pngs`' processes;
    JPEG decodes and the resizes run in LOAD_THREADS threads (the host
    library releases the interpreter lock). blend_alpha_white composites an
    RGBA image onto white after the resize, rgb * a + (1 - a) in f32
    (Blender)."""
    wh = tuple(int(x) for x in img_wh)
    is_png = [p.lower().endswith(".png") for p in paths]
    decoded = iter(read_pngs([p for p, ok in zip(paths, is_png) if ok]))
    pngs = [next(decoded) if ok else None for ok in is_png]
    jobs = [(p, png, wh, resample, blend_alpha_white) for p, png in zip(paths, pngs)]
    if len(jobs) <= 1:
        return [_load_one(*job) for job in jobs]
    return list(_threads().map(lambda job: _load_one(*job), jobs))


def load_image(path: str, img_wh, resample: str = "lanczos",
               blend_alpha_white: bool = False) -> np.ndarray:
    """One image of `load_images`."""
    return load_images([path], img_wh, resample, blend_alpha_white)[0]


def image_size(path: str):
    """(width, height) of a PNG or JPEG file, from its header (tnt.py:87-91
    reads it through PIL)."""
    if path.lower().endswith(".png"):
        return png_size(path)
    if is_jpeg(path):
        return jpeg_size(path)
    raise ValueError(f"{path}: only PNG and JPEG images are read")


def read_pfm(filename: str):
    """Portable float map -> (data [H,W] or [H,W,3] float32, scale)
    (common.py:57)."""
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim_match = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dim_match:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale


def load_pairs_file(path: str) -> Dict:
    """The MVSNeRF `pairs.th` view-split file (a torch-serialised dict of
    lists and numpy arrays), or a .npz (common.py:79)."""
    if path.endswith(".npz"):
        return dict(np.load(path, allow_pickle=True))
    import torch
    return torch.load(path, map_location="cpu", weights_only=False)


def read_mvsnet_cam_file(filename: str):
    """MVSNet cam file -> (intrinsic [3,3] f32, extrinsic [4,4] f32, the
    depth line's numbers) (common.py:156); each number parses to float64,
    then rounds to float32, as np.fromstring does."""
    with open(filename) as f:
        lines = [line.rstrip() for line in f.readlines()]

    def floats(text, shape):
        return np.array([float(x) for x in text.split()], np.float64) \
            .astype(np.float32).reshape(shape)

    extrinsic = floats(" ".join(lines[1:5]), (4, 4))
    intrinsic = floats(" ".join(lines[7:10]), (3, 3))
    depth_tokens = [float(x) for x in lines[11].split()]
    return intrinsic, extrinsic, depth_tokens


def resize_nearest(a: np.ndarray, f: float) -> np.ndarray:
    """`cv2.resize(a, None, fx=f, fy=f, interpolation=cv2.INTER_NEAREST)` as
    numpy indexing: the output is round(size * f) on each axis and takes
    source index min(floor(i / f), size - 1)."""
    def index(n):
        m = int(np.rint(n * f))
        return np.minimum(np.floor(np.arange(m) * (1.0 / f)).astype(np.int64), n - 1)

    return a[index(a.shape[0])][:, index(a.shape[1])]


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


def average_poses(poses: np.ndarray) -> np.ndarray:
    """[N,3,4] c2w -> the average pose [3,4] (common.py:108): the mean
    centre, the normalised mean z axis, x = y_mean x z, y = z x x."""
    center = poses[..., 3].mean(0)
    z = poses[..., 2].mean(0)
    z = z / np.linalg.norm(z)
    y_ = poses[..., 1].mean(0)
    x = np.cross(y_, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray, blender2opencv: np.ndarray = BLENDER2OPENCV) -> np.ndarray:
    """c2w poses [N,3,4] re-centred at their average pose, then in OpenCV
    axes (common.py:121)."""
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = average_poses(poses)
    last_row = np.tile(np.array([0, 0, 0, 1]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    centered = np.linalg.inv(pose_avg_homo) @ poses_homo
    return (centered @ blender2opencv)[:, :3]


def load_llff_poses(meta_filepath: str, center: bool = True, scale_mult: float = 0.75):
    """poses_bounds.npy -> (poses [N,3,4] c2w OpenCV, bounds [N,2], hwf
    [N,3]), re-centred at the average pose with `center` (LLFF; the COLMAP
    loader keeps relative coordinates), scaled so the nearest depth is
    ~1/scale_mult (common.py:130)."""
    poses_bounds = np.load(meta_filepath)
    raw = poses_bounds[:, :15].copy().reshape(-1, 3, 5)
    hwf = raw[:, :, 4].copy()
    poses = np.concatenate([raw[..., 1:2], -raw[..., :1], raw[..., 2:4]], -1)
    if center:
        poses = center_poses(poses, BLENDER2OPENCV)
    else:
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
