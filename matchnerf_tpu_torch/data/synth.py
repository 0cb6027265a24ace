"""Synthetic posed-scene generator: a tiny numpy Lambertian raytracer.

The port's own copy of matchnerf_tpu/data/synth.py (numpy only, the same
arithmetic, so the same arguments give bit-identical images, w2cs and
intrinsics). It produces geometrically consistent multi-view scenes
(spheres + box + checker plane + sky) with OpenCV-convention cameras;
chip_smoke.py renders its scene from them. `write_dtu_tree` lays such
views out as a DTU (MVSNet) directory tree with its own meta directory;
`write_dtu_scene` writes the scene's six-view DTU scan. `write_llff_tree`,
`write_blender_tree` and `write_tnt_tree` write the scene as an LLFF,
Blender (NeRF-synthetic) or Tanks-and-Temples test set, each with the
`pairs.th` of its own meta directory; LLFF and Blender as PNGs (no PIL),
T&T as the JPEGs its loader names (PIL needed).
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
           "write_dtu_scene", "DTU_SCENE_VIEW_IDS", "forward_facing_eyes", "write_llff_tree",
           "write_blender_tree", "write_tnt_tree"]

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


def write_dtu_scene(root: str, meta_dir: str, W: int = 640, H: int = 512):
    """Six views of the scene at 640x512 (or W x H) on an arc, as scan1 of
    a DTU tree (DTU view ids 20-25; 24, in the middle, is the validation
    and test target; 20, the first reference view of the training metas,
    is next to it) with depth_min 425 and interval 2.5 (near / far 2.125 /
    4.525), its own meta dir and depth maps (0 on the sky)."""
    radius = 3.7
    angles = np.deg2rad([-4.0, -12.0, 4.0, 12.0, 0.0, -20.0])
    eyes = [(radius * math.sin(a), -1.0, -radius * math.cos(a)) for a in angles]
    views = make_scene_views(W, H, focal=1.8 * W, eyes=eyes)
    images = np.round(views["images"] * 255.0).astype(np.uint8)
    write_dtu_tree(root, meta_dir, images, views["w2cs"], views["intrinsics"],
                   DTU_SCENE_VIEW_IDS, val_view=24, depths=views["depths"])


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


def write_llff_tree(root: str, meta_dir: str, W: int, H: int, n_views: int = 5,
                    test_views: Sequence[int] = (2,), scene: str = "fern"):
    """The scene seen from `forward_facing_eyes(n_views)` as one LLFF scene
    the LLFF loader reads (data/llff.py): `{scene}/images/{i:03d}.png` at
    W x H, so no resize is needed, and `{scene}/poses_bounds.npy` (LLFF's
    [down, right, back] camera axes, the image's h, w, focal, and each
    view's near/far from its hit depths); meta_dir/pairs.th with
    `test_views` the targets of eval_mode mvsnerf and the other views their
    candidates. eval_mode gpnr holds out every 8th image instead."""
    views = make_scene_views(W, H, eyes=forward_facing_eyes(n_views))
    images = _u8(views)
    img_dir = os.path.join(root, scene, "images")
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
    np.save(os.path.join(root, scene, "poses_bounds.npy"), poses_bounds)
    _save_pairs(meta_dir, scene, *_split(n_views, test_views))


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


def write_tnt_tree(root: str, meta_dir: str, W: int, H: int, n_views: int = 5,
                   test_views: Sequence[int] = (2,), scene: str = "Truck",
                   depth_scale: float = 500.0):
    """The scene from `forward_facing_eyes(n_views)` as one Tanks-and-
    Temples scene the T&T loader reads (data/tnt.py): `{scene}/images/
    {i:08d}.jpg` at W x H (written with PIL, which must be installed) and
    `{scene}/cams_1/{i:08d}_cam.txt` with the world-to-camera translation
    and the depth bounds divided by `depth_scale` (the loader multiplies
    them back) and the intrinsics at W x H; meta_dir/pairs.th with
    `test_views` the targets."""
    from PIL import Image
    views = make_scene_views(W, H, eyes=forward_facing_eyes(n_views))
    images = _u8(views)
    img_dir, cam_dir = (os.path.join(root, scene, d) for d in ("images", "cams_1"))
    for d in (img_dir, cam_dir):
        os.makedirs(d, exist_ok=True)
    for i in range(n_views):
        Image.fromarray(images[i]).save(os.path.join(img_dir, f"{i:08d}.jpg"), quality=95)
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
