"""Synthetic posed-scene generator: a tiny numpy Lambertian raytracer.

The port's own copy of matchnerf_tpu/data/synth.py (numpy only, the same
arithmetic, so the same arguments give bit-identical images, w2cs and
intrinsics). It produces geometrically consistent multi-view scenes
(spheres + box + checker plane + sky) with OpenCV-convention cameras;
chip_smoke.py renders its scene from them. `write_dtu_tree` lays such
views out as a DTU (MVSNet) directory tree with its own meta directory;
`write_dtu_scene` writes the scene's DTU scan (six views, or up to
twelve). `write_llff_tree`, `write_blender_tree` and `write_tnt_tree`
write the scene as an LLFF, Blender (NeRF-synthetic) or Tanks-and-Temples
test set, each with the `pairs.th` of its own meta directory; LLFF and
Blender as PNGs, T&T as the JPEGs its loader names, written by
`encode_jpeg` (a numpy baseline encoder; no PIL anywhere). `write_ibrnet_tree` writes IBRNet's two-level
training tree of forward-facing scenes (PNGs).
"""
import json
import math
import os
import shutil
from typing import Sequence, Tuple

import numpy as np

from .common import BLENDER2OPENCV
from .png import write_png

__all__ = ["look_at_opencv", "render_scene", "make_scene_views", "write_dtu_tree",
           "write_dtu_scene", "DTU_SCENE_VIEW_IDS", "dtu_scene_view_ids", "forward_facing_eyes",
           "write_llff_tree", "write_ibrnet_tree", "write_blender_tree", "write_tnt_tree",
           "encode_jpeg"]

DTU_SCENE_VIEW_IDS = (20, 21, 22, 23, 24, 25)     # the views of `write_dtu_scene`


def _normalize(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def look_at_opencv(eye, target, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """c2w [3,4] in OpenCV convention: x right, y down, z forward. `up` is
    the world-up direction (-y here: world y points down)."""
    eye = np.asarray(eye, np.float64)
    z = _normalize(np.asarray(target, np.float64) - eye)
    x = _normalize(np.cross(z, np.asarray(up, np.float64)))
    y = np.cross(z, x)
    return np.stack([x, y, z, eye], axis=1)


def render_scene(c2w: np.ndarray, W: int, H: int, focal: float,
                 plane_radius: float = 10.0,
                 checker_scale: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """Raytrace the fixed demo scene from c2w [3,4] (OpenCV).

    Returns (img uint8 [H,W,3] RGB gamma-encoded, t_hit [H,W] float with inf
    at sky pixels). Principal point at the image center, +0.5 pixel centers.
    """
    i, j = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    dirs_cam = np.stack([(i - W / 2) / focal, (j - H / 2) / focal,
                         np.ones_like(i)], axis=-1)
    d = _normalize(dirs_cam @ c2w[:3, :3].T)
    o = np.broadcast_to(c2w[:3, 3], d.shape)

    t_hit = np.full((H, W), np.inf)
    color = np.zeros((H, W, 3))
    normal = np.zeros((H, W, 3))

    def register(t, n, albedo, mask):
        closer = mask & (t < t_hit)
        t_hit[closer] = t[closer]
        normal[closer] = n[closer]
        color[closer] = np.broadcast_to(albedo, n.shape)[closer]

    # ground plane y = 0.55 (y points down -> below the objects), bounded to
    # a disk so the horizon doesn't alias into moire
    denom = d[..., 1]
    t = np.where(np.abs(denom) > 1e-8, (0.55 - o[..., 1]) / denom, np.inf)
    p = o + t[..., None] * d
    checker = ((np.floor(p[..., 0] * checker_scale)
                + np.floor(p[..., 2] * checker_scale)) % 2)
    plane_col = np.where(checker[..., None] > 0.5, [0.62, 0.57, 0.50],
                         [0.38, 0.35, 0.32])
    mask = (t > 1e-4) & np.isfinite(t) & \
        (p[..., 0] ** 2 + p[..., 2] ** 2 < plane_radius ** 2)
    closer = mask & (t < t_hit)
    t_hit[closer] = t[closer]
    normal[closer] = [0.0, -1.0, 0.0]
    color[closer] = plane_col[closer]

    # axis-aligned box (the "printer"): slab method
    bmin = np.array([-0.55, -0.15, -0.35])
    bmax = np.array([0.55, 0.55, 0.45])
    inv = 1.0 / np.where(np.abs(d) > 1e-9, d, 1e-9)
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    tn = np.minimum(t0, t1).max(-1)
    tf = np.maximum(t0, t1).min(-1)
    hit = (tf > np.maximum(tn, 1e-4))
    p = o + tn[..., None] * d
    eps = 1e-4
    n_box = np.zeros_like(p)
    for ax in range(3):
        n_box[..., ax] = np.where(np.abs(p[..., ax] - bmin[ax]) < eps, -1.0,
                                  np.where(np.abs(p[..., ax] - bmax[ax]) < eps,
                                           1.0, 0.0))
    register(tn, _normalize(n_box + 1e-9), [0.82, 0.80, 0.78], hit)

    # spheres: (center, radius, albedo)
    for c, r, alb in [([-0.95, 0.30, 0.30], 0.25, [0.85, 0.25, 0.20]),
                      ([0.95, 0.35, -0.10], 0.20, [0.20, 0.45, 0.85]),
                      ([0.15, -0.35, 0.05], 0.20, [0.25, 0.75, 0.35])]:
        oc = o - np.asarray(c)
        b = np.sum(oc * d, -1)
        disc = b * b - (np.sum(oc * oc, -1) - r * r)
        ok = disc > 0
        t = -b - np.sqrt(np.where(ok, disc, 0.0))
        p = o + t[..., None] * d
        register(t, _normalize(p - np.asarray(c)), alb, ok & (t > 1e-4))

    light = _normalize(np.array([0.4, -0.8, -0.45]))
    lam = np.clip(np.sum(normal * light, -1), 0, 1)
    shade = (0.35 + 0.65 * lam)[..., None] * color
    sky = np.array([0.65, 0.75, 0.92]) * \
        (0.75 + 0.25 * np.clip(-d[..., 1:2], 0, 1))
    img = np.where(np.isfinite(t_hit)[..., None], shade, sky)
    return (np.clip(img, 0, 1) ** (1 / 2.2) * 255).astype(np.uint8), t_hit


DEFAULT_EYES = ([-1.3, -0.9, -3.6], [0.0, -1.05, -3.8], [1.3, -0.85, -3.55],
                [0.0, -1.6, -3.4])


def make_scene_views(W: int, H: int, focal: float = None,
                     eyes: Sequence = None, target=(0.0, 0.1, 0.0),
                     far_clip: float = 12.0):
    """Render N consistent views; returns a dict of numpy arrays matching the
    dataset sample contract pieces:

    images   [N,H,W,3] float32 in [0,1] (linear from the uint8 render)
    c2ws     [N,4,4] float32 OpenCV camera-to-world
    w2cs     [N,4,4] float32
    intrinsics [N,3,3] float32
    near_fars  [N,2] float32 (per-view, from hit depths, far <= far_clip*1.1)
    depths   [N,H,W] float32 hit distances (inf at sky)
    """
    if focal is None:
        focal = 0.83 * W
    eyes = DEFAULT_EYES if eyes is None else eyes
    images, c2ws, w2cs, intrs, nfs, depths = [], [], [], [], [], []
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                 np.float32)
    for eye in eyes:
        c2w34 = look_at_opencv(eye, target)
        img, t_hit = render_scene(c2w34, W, H, focal)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3] = c2w34.astype(np.float32)
        finite = t_hit[np.isfinite(t_hit) & (t_hit < far_clip)]
        near = max(float(np.percentile(finite, 0.5)) * 0.9, 1e-2)
        far = float(np.percentile(finite, 99.5)) * 1.1
        images.append(img.astype(np.float32) / 255.0)
        c2ws.append(c2w)
        w2cs.append(np.linalg.inv(c2w.astype(np.float64)).astype(np.float32))
        intrs.append(K)
        nfs.append([near, far])
        depths.append(t_hit.astype(np.float32))
    return {"images": np.stack(images), "c2ws": np.stack(c2ws),
            "w2cs": np.stack(w2cs), "intrinsics": np.stack(intrs),
            "near_fars": np.asarray(nfs, np.float32),
            "depths": np.stack(depths)}


def write_pfm(path: str, data: np.ndarray):
    """A greyscale little-endian PFM file (rows bottom to top)."""
    h, w = data.shape
    with open(path, "wb") as f:
        f.write(f"Pf\n{w} {h}\n-1.0\n".encode())
        f.write(np.flipud(data).astype("<f4").tobytes())


def write_dtu_tree(root: str, meta_dir: str, images: np.ndarray, w2cs: np.ndarray,
                   intrinsics: np.ndarray, view_ids: Sequence[int], val_view: int,
                   depths: np.ndarray = None, scan: str = "scan1",
                   depth_min: float = 425.0, depth_interval: float = 2.5):
    """Write N posed views as one DTU scan the DTU loader reads
    (data/dtu.py): images [N,H,W,3] uint8 (H, W = 512, 640 as DTU's, or
    smaller multiples of 32 for tests), w2cs [N,4,4] and intrinsics [N,3,3]
    in the loader's units (the files hold translations x200 and intrinsics
    /4), under DTU view ids `view_ids`.

    - Rectified/{scan}_train/rect_{id+1:03d}_{light}_r5000.png for the 7
      lights (one image each; each PNG row with the filter an encoder's
      adaptive choice gives it, `png.write_png`'s default);
    - Cameras/train/{id:08d}_cam.txt with `depth_min depth_interval` (near =
      depth_min / 200, far = near + 192 * depth_interval / 200);
    - Depths/{scan}/depth_map_{id:04d}.pfm at 1200x1600 (0 where `depths`
      [N,H,W] is not finite, or everywhere without it), which the loader
      halves and crops back to the image; for a smaller image, at
      (2H + 88) x (2W + 160), which the same crop takes to H x W;
    - meta_dir/dtu_meta/{train,val}_all.txt naming the scan, view_pairs.txt
      with every view a reference and the others its sources by distance,
      and meta_dir/pairs.th with `val_view` the test target and the others
      its candidates. `val_view` must be 24, DTU's validation view."""
    import torch
    images = np.asarray(images)
    N, H, W = images.shape[:3]
    if (H, W) != (512, 640) and (H > 512 or W > 640 or H % 32 or W % 32):
        raise ValueError(f"DTU images are 512x640 (or smaller multiples of 32), got {H}x{W}")
    depth_hw = (1200, 1600) if (H, W) == (512, 640) else (2 * H + 88, 2 * W + 160)
    rect = os.path.join(root, "Rectified", f"{scan}_train")
    cams = os.path.join(root, "Cameras", "train")
    dep = os.path.join(root, "Depths", scan)
    for d in (rect, cams, dep, os.path.join(meta_dir, "dtu_meta")):
        os.makedirs(d, exist_ok=True)
    centers = np.stack([np.linalg.inv(np.asarray(e, np.float64))[:3, 3] for e in w2cs])
    for n, vid in enumerate(view_ids):
        first = os.path.join(rect, f"rect_{vid + 1:03d}_0_r5000.png")
        write_png(first, images[n])
        for light in range(1, 7):
            shutil.copyfile(first, os.path.join(rect, f"rect_{vid + 1:03d}_{light}_r5000.png"))
        extr = np.asarray(w2cs[n], np.float64).copy()
        extr[:3, 3] *= 200.0
        intr = np.asarray(intrinsics[n], np.float64) / 4.0
        intr[2, 2] = 1.0
        with open(os.path.join(cams, f"{vid:08d}_cam.txt"), "w") as f:
            f.write("extrinsic\n")
            f.writelines(" ".join(repr(float(v)) for v in row) + "\n" for row in extr)
            f.write("\nintrinsic\n")
            f.writelines(" ".join(repr(float(v)) for v in row) + "\n" for row in intr)
            f.write(f"\n{depth_min} {depth_interval}\n")
        big = np.zeros(depth_hw, np.float32)
        if depths is not None:
            d = np.where(np.isfinite(depths[n]), depths[n] * 200.0, 0.0)
            big[88:88 + 2 * H:2, 160:160 + 2 * W:2] = d
        write_pfm(os.path.join(dep, f"depth_map_{vid:04d}.pfm"), big)
    for name in ("train_all.txt", "val_all.txt"):
        with open(os.path.join(meta_dir, "dtu_meta", name), "w") as f:
            f.write(f"{scan}\n")
    with open(os.path.join(meta_dir, "dtu_meta", "view_pairs.txt"), "w") as f:
        f.write(f"{N}\n")
        for n, vid in enumerate(view_ids):
            dist = np.abs(centers - centers[n]).sum(-1)
            order = [m for m in np.argsort(dist, kind="stable") if m != n]
            f.write(f"{vid}\n{len(order)} "
                    + " ".join(f"{view_ids[m]} {100.0 - dist[m]:.3f}" for m in order) + "\n")
    if val_view not in view_ids:
        raise ValueError(f"val_view {val_view} is not among the views {list(view_ids)}")
    torch.save({"dtu_train": [int(v) for v in view_ids if v != val_view],
                "dtu_test": [int(val_view)]}, os.path.join(meta_dir, "pairs.th"))


# the arc angles (degrees) of `write_dtu_scene`'s views: DTU_SCENE_VIEW_IDS'
# six, then the views it adds beyond six (ids 19, 18, ..., 14), alternating
# sides further out
_DTU_SCENE_ANGLES = (-4.0, -12.0, 4.0, 12.0, 0.0, -20.0, 20.0, -28.0, 28.0, -36.0, 36.0, -44.0)


def dtu_scene_view_ids(n_views: int = 6) -> Tuple[int, ...]:
    """The DTU view ids of `write_dtu_scene(..., n_views)`, in its order:
    20-25, then 19 down to 26 - n_views."""
    if not len(DTU_SCENE_VIEW_IDS) <= n_views <= len(_DTU_SCENE_ANGLES):
        raise ValueError(f"write_dtu_scene: n_views={n_views}, it writes "
                         f"{len(DTU_SCENE_VIEW_IDS)} to {len(_DTU_SCENE_ANGLES)} views")
    return DTU_SCENE_VIEW_IDS + tuple(range(19, 25 - n_views, -1))


def write_dtu_scene(root: str, meta_dir: str, W: int = 640, H: int = 512, n_views: int = 6,
                    spread: float = 1.0):
    """n_views (6 to 12) views of the scene at 640x512 (or W x H) on an
    arc, their angles `spread` times the default ones (8 degrees apart at
    1.0), as scan1 of a DTU tree (DTU view ids 20-25, then 19, 18, ...,
    `dtu_scene_view_ids`; 24, in the middle, is the validation and test
    target; 20, the first reference view of the training metas, is next to
    it) with depth_min 425 and interval 2.5 (near / far 2.125 / 4.525), its
    own meta dir and depth maps (0 on the sky). The six views of the default
    are the first six of every larger tree; training at n_src_views V with
    the loader's 2 added candidates needs V + 3 views (11 at V = 8)."""
    view_ids = dtu_scene_view_ids(n_views)
    radius = 3.7
    angles = np.deg2rad(np.asarray(_DTU_SCENE_ANGLES[:n_views]) * spread)
    eyes = [(radius * math.sin(a), -1.0, -radius * math.cos(a)) for a in angles]
    views = make_scene_views(W, H, focal=1.8 * W, eyes=eyes)
    images = np.round(views["images"] * 255.0).astype(np.uint8)
    write_dtu_tree(root, meta_dir, images, views["w2cs"], views["intrinsics"],
                   view_ids, val_view=24, depths=views["depths"])


def forward_facing_eyes(n: int, spread: float = 0.9):
    """n camera centres on a 2-row grid in a plane in front of the scene,
    as a hand-held forward-facing capture (LLFF, T&T) places them."""
    cols = (n + 1) // 2
    xs = np.linspace(-spread / 2, spread / 2, cols)
    return [(float(xs[i % cols]) + 0.05 * (i // cols), -1.0 + 0.3 * (i // cols), -3.7)
            for i in range(n)]


def _u8(views) -> np.ndarray:
    return np.round(views["images"] * 255.0).astype(np.uint8)


def _save_pairs(meta_dir: str, prefix: str, train_views, test_views):
    import torch
    os.makedirs(meta_dir, exist_ok=True)
    torch.save({f"{prefix}_train": [int(v) for v in train_views],
                f"{prefix}_val": [int(v) for v in test_views]},
               os.path.join(meta_dir, "pairs.th"))


def _split(n: int, test_views: Sequence[int]):
    test = [int(v) for v in test_views]
    return [v for v in range(n) if v not in test], test


def _write_llff_scene(scene_dir: str, views, W: int, H: int):
    """`views` of make_scene_views as one poses_bounds.npy scene:
    `images/{i:03d}.png` at W x H and `poses_bounds.npy` (LLFF's [down,
    right, back] camera axes, the image's h, w, focal, and each view's
    near/far from its hit depths)."""
    images = _u8(views)
    n_views = len(images)
    img_dir = os.path.join(scene_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    raw = np.zeros((n_views, 3, 5))
    for i in range(n_views):
        write_png(os.path.join(img_dir, f"{i:03d}.png"), images[i])
        c2w = views["c2ws"][i].astype(np.float64)
        # OpenCV [right, down, forward] -> LLFF [down, right, back]
        raw[i, :, :4] = np.stack([c2w[:3, 1], c2w[:3, 0], -c2w[:3, 2], c2w[:3, 3]], axis=1)
        raw[i, :, 4] = [H, W, views["intrinsics"][i][0, 0]]
    poses_bounds = np.concatenate([raw.reshape(n_views, 15),
                                   views["near_fars"].astype(np.float64)], axis=1)
    np.save(os.path.join(scene_dir, "poses_bounds.npy"), poses_bounds)


def write_llff_tree(root: str, meta_dir: str, W: int, H: int, n_views: int = 5,
                    test_views: Sequence[int] = (2,), scene: str = "fern"):
    """The scene seen from `forward_facing_eyes(n_views)` as one LLFF scene
    the LLFF loader reads (data/llff.py): `{scene}/images/{i:03d}.png` at
    W x H, so no resize is needed, and `{scene}/poses_bounds.npy`
    (`_write_llff_scene`); meta_dir/pairs.th with `test_views` the targets
    of eval_mode mvsnerf and the other views their candidates. eval_mode
    gpnr holds out every 8th image instead."""
    views = make_scene_views(W, H, eyes=forward_facing_eyes(n_views))
    _write_llff_scene(os.path.join(root, scene), views, W, H)
    _save_pairs(meta_dir, scene, *_split(n_views, test_views))


def write_ibrnet_tree(root: str, W: int, H: int, n_views: int = 8,
                      scenes: Sequence[str] = ("ibrnet_collected_1/scene0",
                                               "real_iconic_noface/scene1")):
    """The scene as the IBRNet loader's two-level tree (data/llff.py
    `IBRNetDataset`): one poses_bounds.npy scene (`_write_llff_scene`) at
    `root/<group>/<scene>/` per entry of `scenes`, each seen from its own
    `forward_facing_eyes(n_views)` grid (the i-th scene's spread 0.9 +
    0.15 i), PNGs at W x H."""
    for i, name in enumerate(scenes):
        views = make_scene_views(W, H, eyes=forward_facing_eyes(n_views, 0.9 + 0.15 * i))
        _write_llff_scene(os.path.join(root, name), views, W, H)


def write_blender_tree(root: str, meta_dir: str, W: int, H: int, n_train: int = 4,
                       n_test: int = 1, scene: str = "lego", radius: float = 3.7):
    """The scene on an arc of n_train + n_test cameras as one Blender scene
    the Blender loader reads (data/blender.py), RGBA PNGs at W x H: alpha 1
    up to depth 5.5 and fading to 0 at 6 (the loader's far; the sky is 0),
    so images have a real alpha to blend onto white. transforms_train.json
    holds the train views' frames (`./train/r_i`) and then the test views'
    (`./test/r_j`), transforms_test.json the test views'; meta_dir/pairs.th
    names frames n_train.. of transforms_train.json the targets of
    eval_mode mvsnerf. eval_mode gpnr reads train/ and test/."""
    n = n_train + n_test
    angles = np.deg2rad(np.linspace(-24.0, 24.0, n))
    order = [i for i in range(n) if i != n // 2] + [n // 2]      # a test view in the middle
    eyes = [(radius * math.sin(angles[i]), -1.0, -radius * math.cos(angles[i])) for i in order]
    views = make_scene_views(W, H, eyes=eyes)
    rgb = _u8(views)
    t = views["depths"]
    alpha = np.round(np.clip((6.0 - np.where(np.isfinite(t), t, np.inf)) / 0.5, 0.0, 1.0)
                     * 255.0).astype(np.uint8)
    focal = float(views["intrinsics"][0][0, 0])
    frames = {"train": [], "test": []}
    for i in range(n):
        split, j = ("train", i) if i < n_train else ("test", i - n_train)
        os.makedirs(os.path.join(root, scene, split), exist_ok=True)
        write_png(os.path.join(root, scene, split, f"r_{j}.png"),
                  np.concatenate([rgb[i], alpha[i][..., None]], axis=-1))
        # OpenCV camera-to-world -> Blender's (the flip is its own inverse)
        c2w = views["c2ws"][i].astype(np.float64) @ BLENDER2OPENCV
        frames[split].append({"file_path": f"./{split}/r_{j}",
                              "transform_matrix": c2w.tolist()})
    angle_x = 2.0 * math.atan(0.5 * W / focal)
    for name, frame_list in (("train", frames["train"] + frames["test"]),
                             ("test", frames["test"])):
        with open(os.path.join(root, scene, f"transforms_{name}.json"), "w") as f:
            json.dump({"camera_angle_x": angle_x, "frames": frame_list}, f)
    _save_pairs(meta_dir, scene, range(n_train), range(n_train, n))



# ----------------------------------------------------------------- JPEG writer
# A small baseline JPEG encoder (SOF0, the standard Huffman tables), numpy
# only, so that a JPEG tree is written without PIL. Its bytes
# need not equal another encoder's; PIL and the port's decoder must decode
# them to the same array.

_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
                    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# ITU-T T.81 Annex K: tables K.1 and K.2 (natural order)
_K1_LUMA = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_K2_CHROMA = np.full(64, 99)
_K2_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = \
    [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# Annex K.3: (number of codes of each length 1..16, symbols) of the DC
# luma, DC chroma, AC luma and AC chroma tables
_HUFF_SPECS = (
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
        "01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07 22 71 14 32 81 91 a1 08"
        "23 42 b1 c1 15 52 d1 f0 24 33 62 72 82 09 0a 16 17 18 19 1a 25 26 27 28"
        "29 2a 34 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58 59"
        "5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 83 84 85 86 87 88 89"
        "8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8 a9 aa b2 b3 b4 b5 b6"
        "b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da e1 e2"
        "e3 e4 e5 e6 e7 e8 e9 ea f1 f2 f3 f4 f5 f6 f7 f8 f9 fa")),
    ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
        "00 01 02 03 11 04 05 21 31 06 12 41 51 07 61 71 13 22 32 81 08 14 42 91"
        "a1 b1 c1 09 23 33 52 f0 15 62 72 d1 0a 16 24 34 e1 25 f1 17 18 19 1a 26"
        "27 28 29 2a 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58"
        "59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 82 83 84 85 86 87"
        "88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8 a9 aa b2 b3 b4"
        "b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da"
        "e2 e3 e4 e5 e6 e7 e8 e9 ea f2 f3 f4 f5 f6 f7 f8 f9 fa")),
)
_PACK_TOKENS = 1 << 20                 # tokens turned into bits at a time


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """An Annex K table scaled by quality 1-100 as libjpeg's
    `jpeg_quality_scaling` and `jpeg_add_quant_table` (baseline: <= 255)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huff_codes(bits, vals):
    """Canonical Huffman (code, length) of each symbol (T.81 Annex C)."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _magnitude(v):
    """(size category, the extra bits) of JPEG's value coding."""
    s = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    return s, np.where(v < 0, v + (1 << s) - 1, v).astype(np.int64)


def _tokens(zz, table, dc_diff):
    """(value, length) of every Huffman token of the blocks `zz` [N,64]
    (zig-zag order, coding order), each block coded with table set
    `table[i]` (0 luma, 1 chroma), in stream order."""
    n = len(zz)
    codes = [_huff_codes(*spec) for spec in _HUFF_SPECS]
    blk = np.arange(n, dtype=np.int64)
    s, extra = _magnitude(dc_diff)
    dc_code = np.where(table == 0, codes[0][0][s], codes[1][0][s])
    dc_len = np.where(table == 0, codes[0][1][s], codes[1][1][s])
    keys, vals, lens = [blk * 256], [(dc_code << s) | extra], [dc_len + s]
    last = np.zeros(n, np.int64)
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    if len(b):
        first = np.ones(len(b), bool)
        first[1:] = b[1:] != b[:-1]
        prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
        run = k - prev - 1
        s, extra = _magnitude(zz[b, k])
        sym = ((run % 16) << 4) | s
        t = table[b]
        keys.append(b * 256 + 2 * k + 1)
        vals.append((np.where(t == 0, codes[2][0][sym], codes[3][0][sym]) << s) | extra)
        lens.append(np.where(t == 0, codes[2][1][sym], codes[3][1][sym]) + s)
        zrl = np.repeat(np.arange(len(b)), run // 16)         # runs of 16 zeros
        keys.append(b[zrl] * 256 + 2 * k[zrl])
        vals.append(np.where(t[zrl] == 0, codes[2][0][0xF0], codes[3][0][0xF0]))
        lens.append(np.where(t[zrl] == 0, codes[2][1][0xF0], codes[3][1][0xF0]))
        np.maximum.at(last, b, k)                           # last nonzero per block
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 256 + 255)
    vals.append(np.where(table[eob] == 0, codes[2][0][0], codes[3][0][0]))
    lens.append(np.where(table[eob] == 0, codes[2][1][0], codes[3][1][0]))
    order = np.argsort(np.concatenate(keys), kind="stable")
    return np.concatenate(vals)[order], np.concatenate(lens)[order]


def _pack(vals, lens) -> bytes:
    """Tokens -> entropy-coded bytes: MSB first, padded with 1 bits, each
    0xFF byte followed by a stuffed 0x00."""
    chunks, carry = [], np.zeros(0, np.uint8)
    for i in range(0, len(vals), _PACK_TOKENS):
        v, ln = vals[i:i + _PACK_TOKENS], lens[i:i + _PACK_TOKENS]
        tok = np.repeat(np.arange(len(v)), ln)
        start = np.cumsum(ln) - ln
        shift = (ln[tok] - 1 - (np.arange(len(tok)) - start[tok])).astype(np.int64)
        bits = np.concatenate([carry, ((v[tok] >> shift) & 1).astype(np.uint8)])
        whole = len(bits) // 8 * 8
        chunks.append(np.packbits(bits[:whole]))
        carry = bits[whole:]
    if len(carry):
        pad = np.ones(8 - len(carry), np.uint8)
        chunks.append(np.packbits(np.concatenate([carry, pad])))
    out = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    out = np.insert(out, np.nonzero(out == 0xFF)[0] + 1, 0)
    return out.tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _fdct_pass(x, first: bool):
    """One 1-D pass of libjpeg's integer forward DCT (jfdctint.c
    jpeg_fdct_islow) along the last axis of int64 `x`; the row pass
    (first) keeps 2 extra bits, the column pass removes them."""
    c, p = 13, 2                        # CONST_BITS, PASS1_BITS

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n
    d = [x[..., i] for i in range(8)]
    t0, t7, t1, t6 = d[0] + d[7], d[0] - d[7], d[1] + d[6], d[1] - d[6]
    t2, t5, t3, t4 = d[2] + d[5], d[2] - d[5], d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = [None] * 8
    odd = c - p if first else c + p
    out[0] = (t10 + t11) << p if first else descale(t10 + t11, p)
    out[4] = (t10 - t11) << p if first else descale(t10 - t11, p)
    z1 = (t12 + t13) * 4433
    out[2] = descale(z1 + t13 * 6270, odd)
    out[6] = descale(z1 - t12 * 15137, odd)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * 9633
    t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    out[7] = descale(t4 + z1 + z3, odd)
    out[5] = descale(t5 + z2 + z4, odd)
    out[3] = descale(t6 + z2 + z3, odd)
    out[1] = descale(t7 + z1 + z4, odd)
    return np.stack(out, axis=-1)


def _downsample(plane, fy: int, fx: int):
    """libjpeg's downsampling (jcsample.c) of an int64 plane by (fy, fx):
    2x2 and 2x1 boxes with the alternating biases 1, 2 and 0, 1 along each
    row, other boxes by their rounded mean."""
    h, w = plane.shape[0] // fy, plane.shape[1] // fx
    box = plane.reshape(h, fy, w, fx).sum(axis=(1, 3))
    if (fy, fx) == (2, 2):
        bias = np.where(np.arange(w) % 2 == 0, 1, 2)
    elif (fy, fx) == (1, 2):
        bias = np.arange(w) % 2
    else:
        bias = np.full(w, (fy * fx) // 2)
    return (box + bias) // (fy * fx)


def _rgb_to_ycc(x):
    """libjpeg's fixed-point RGB -> YCbCr (jccolor.c rgb_ycc_convert, 16
    scale bits) of an int64 [H,W,3] image: the Y, Cb and Cr planes."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]

    def fix(v):
        return int(v * 65536 + 0.5)
    half, off = 1 << 15, 128 << 16
    return [(fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16,
            (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half - 1) >> 16,
            (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half - 1) >> 16]


def _blocks(plane, grid_hw, fy: int, fx: int, qtab):
    """The quantised DCT blocks [by, bx, 64] (zig-zag order) of one int64
    component plane, padded to `grid_hw` samples (whole MCUs) by repeating
    its last row and column and downsampled by (fy, fx)."""
    pad = ((0, grid_hw[0] - plane.shape[0]), (0, grid_hw[1] - plane.shape[1]))
    ds = _downsample(np.pad(plane, pad, mode="edge"), fy, fx) - 128
    by, bx = ds.shape[0] // 8, ds.shape[1] // 8
    blocks = ds.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
    coef = _fdct_pass(_fdct_pass(blocks, True).swapaxes(-1, -2), False).swapaxes(-1, -2)
    div = qtab.reshape(8, 8) * 8                    # the DCT's outputs are 8x too large
    q = np.sign(coef) * ((np.abs(coef) + (div >> 1)) // div)
    return q.reshape(by, bx, 64)[..., _ZIGZAG]


def _mcus(blocks, h: int, v: int):
    """A component's blocks [by, bx, 64] regrouped per MCU of h x v blocks:
    [n_mcu, v*h, 64] in the order an interleaved scan codes them."""
    my, mx = blocks.shape[0] // v, blocks.shape[1] // h
    return blocks.reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, v * h, 64)


def _entropy_coded(units, tabs, comp_of) -> bytes:
    """The entropy-coded bytes of `units` [n, k, 64] (zig-zag), coded in
    order: block j of each unit with table set tabs[j] (0 luma, 1 chroma),
    its DC predicted from the previous block of component comp_of[j]."""
    tabs, comp_of = np.asarray(tabs), np.asarray(comp_of)
    dc = units[..., 0]
    diff = np.empty_like(dc)
    for i in np.unique(comp_of):
        diff[:, comp_of == i] = np.diff(dc[:, comp_of == i].reshape(-1), prepend=0) \
            .reshape(len(units), -1)
    vals, lens = _tokens(units.reshape(-1, 64), np.tile(tabs, len(units)), diff.reshape(-1))
    return _pack(vals, lens)


def _headers(app: bytes, qtabs, H: int, W: int, comps) -> bytes:
    """SOI, the `app` segment(s), DQT and DHT of the table sets the
    components use, and SOF0 of `comps`: (h, v, table set) per component,
    with ids 1, 2, ..."""
    used = sorted({t for _, _, t in comps})
    out = [b"\xff\xd8", app,
           _segment(0xDB, b"".join(bytes([t]) + bytes(qtabs[t][_ZIGZAG].astype(np.uint8))
                                   for t in used))]
    sof = bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big") + bytes([len(comps)])
    for ci, (h, v, t) in enumerate(comps):
        sof += bytes([ci + 1, (h << 4) | v, t])
    out.append(_segment(0xC0, sof))
    for cls, ids in ((0, (0, 1)), (1, (2, 3))):
        for t in used:
            bits, vals = _HUFF_SPECS[ids[t]]
            out.append(_segment(0xC4, bytes([(cls << 4) | t, *bits]) + vals))
    return b"".join(out)


def _sos(members) -> bytes:
    """The SOS segment of a sequential scan of `members`: (component index,
    table set) each."""
    sos = bytes([len(members)])
    for ci, t in members:
        sos += bytes([ci + 1, (t << 4) | t])
    return _segment(0xDA, sos + bytes([0, 63, 0]))


JFIF_APP0 = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """A baseline JFIF JPEG (SOF0) of a uint8 image, [H,W] (grey) or
    [H,W,3] (RGB, coded as YCbCr 4:2:0 in one interleaved scan): the Annex K
    quantisation tables scaled by `quality` as libjpeg scales them, the
    standard Huffman tables, and integer arithmetic throughout (libjpeg's
    fixed-point RGB -> YCbCr, downsampling, integer DCT and rounding
    division), so the bytes are the same on every machine."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes uint8 [H,W] or [H,W,3], not {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    x = img.astype(np.int64)
    if img.ndim == 2:
        planes, comps = [x], [(1, 1, 0)]
    else:
        planes, comps = _rgb_to_ycc(x), [(2, 2, 0), (1, 1, 1), (1, 1, 1)]
    hmax, vmax = comps[0][:2]
    grid = (-(-H // (8 * vmax)) * 8 * vmax, -(-W // (8 * hmax)) * 8 * hmax)
    qtabs = [quality_table(_K1_LUMA, quality), quality_table(_K2_CHROMA, quality)]
    units = np.concatenate([_mcus(_blocks(p, grid, vmax // v, hmax // h, qtabs[t]), h, v)
                            for p, (h, v, t) in zip(planes, comps)], axis=1)
    tabs = [t for h, v, t in comps for _ in range(h * v)]
    comp_of = [i for i, (h, v, _) in enumerate(comps) for _ in range(h * v)]
    return (_headers(JFIF_APP0, qtabs, H, W, comps)
            + _sos([(i, t) for i, (_, _, t) in enumerate(comps)])
            + _entropy_coded(units, tabs, comp_of) + b"\xff\xd9")


def write_tnt_tree(root: str, meta_dir: str, W: int, H: int, n_views: int = 5,
                   test_views: Sequence[int] = (2,), scene: str = "Truck",
                   depth_scale: float = 500.0):
    """The scene from `forward_facing_eyes(n_views)` as one Tanks-and-
    Temples scene the T&T loader reads (data/tnt.py): `{scene}/images/
    {i:08d}.jpg` at W x H (4:2:0 JPEGs of `encode_jpeg` at quality 95) and
    `{scene}/cams_1/{i:08d}_cam.txt` with the world-to-camera translation
    and the depth bounds divided by `depth_scale` (the loader multiplies
    them back) and the intrinsics at W x H; meta_dir/pairs.th with
    `test_views` the targets."""
    views = make_scene_views(W, H, eyes=forward_facing_eyes(n_views))
    images = _u8(views)
    img_dir, cam_dir = (os.path.join(root, scene, d) for d in ("images", "cams_1"))
    for d in (img_dir, cam_dir):
        os.makedirs(d, exist_ok=True)
    for i in range(n_views):
        with open(os.path.join(img_dir, f"{i:08d}.jpg"), "wb") as f:
            f.write(encode_jpeg(images[i], 95))
        extr = views["w2cs"][i].astype(np.float64).copy()
        extr[:3, 3] /= depth_scale
        near, far = (float(x) / depth_scale for x in views["near_fars"][i])
        with open(os.path.join(cam_dir, f"{i:08d}_cam.txt"), "w") as f:
            f.write("extrinsic\n")
            f.writelines(" ".join(repr(float(v)) for v in row) + "\n" for row in extr)
            f.write("\nintrinsic\n")
            f.writelines(" ".join(repr(float(v)) for v in row) + "\n"
                         for row in views["intrinsics"][i].astype(np.float64))
            f.write(f"\n{near!r} {(far - near) / 192.0!r} 192 {far!r}\n")
    _save_pairs(meta_dir, f"TNT_{scene}", *_split(n_views, test_views))
