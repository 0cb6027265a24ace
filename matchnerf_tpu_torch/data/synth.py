"""Synthetic posed-scene generator: a tiny numpy Lambertian raytracer.

The port's own copy of matchnerf_tpu/data/synth.py (numpy only, the same
arithmetic, so the same arguments give bit-identical images, w2cs and
intrinsics). It produces geometrically consistent multi-view scenes
(spheres + box + checker plane + sky) with OpenCV-convention cameras;
chip_smoke.py renders its scene from them.
"""
from typing import Sequence, Tuple

import numpy as np

__all__ = ["look_at_opencv", "render_scene", "make_scene_views"]


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
