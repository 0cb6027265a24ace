"""Camera / pose / projection math on torch tensors.

Counterpart of matchnerf_tpu/camera.py (the eval render's subset).
Conventions are the same: a pose is a [..., 3, 4] world-to-camera [R|t];
`legacy` pixel grids have no +0.5 centre offset, and the legacy target-pose
inverse is taken host-side in float64 (`pose_inverse_legacy_np`).
"""
from __future__ import annotations

import numpy as np
import torch


def pose_inverse_legacy_np(pose: np.ndarray) -> np.ndarray:
    """float64 4x4 inverse of a [...,3,4] pose, cast back to f32 (host-side;
    camera.py:64)."""
    pose = np.asarray(pose)
    batch_shape = pose.shape[:-2]
    sq = np.broadcast_to(np.eye(4, dtype=np.float64), (*batch_shape, 4, 4)).copy()
    sq[..., :3, :] = pose.astype(np.float64)
    inv = np.linalg.inv(sq)
    return inv[..., :3, :].astype(np.float32)


def pose_inverse(pose: torch.Tensor) -> torch.Tensor:
    """Invert a [...,3,4] rigid pose using R^T (camera.py:40)."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    t_inv = (-R_inv @ t)[..., 0]
    return torch.cat([R_inv, t_inv[..., None]], dim=-1)


def to_hom(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def pixel_grid(img_h: int, img_w: int, legacy: bool = False,
               device=None) -> torch.Tensor:
    """[H*W, 2] (x, y) pixel coordinates, +0.5 centred unless legacy
    (camera.py:113)."""
    off = 0.0 if legacy else 0.5
    y = torch.arange(img_h, dtype=torch.float32, device=device) + off
    x = torch.arange(img_w, dtype=torch.float32, device=device) + off
    Y, X = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([X, Y], dim=-1).reshape(-1, 2)


def get_center_and_ray(xy_grid, intr, c2w):
    """Camera centres and unnormalised ray directions (camera.py:122).

    xy_grid: [R,2] or [B,R,2]; intr: [B,3,3]; c2w: [B,3,4]. Returns
    center, ray: [B,R,3]."""
    if xy_grid.dim() == 2:
        xy_grid = xy_grid[None].expand(intr.shape[0], *xy_grid.shape)
    grid_3d_cam = to_hom(xy_grid) @ torch.linalg.inv(intr).transpose(-1, -2)
    center_3d_cam = torch.zeros_like(grid_3d_cam)
    c2w_T = c2w.transpose(-1, -2)
    grid_3d = to_hom(grid_3d_cam) @ c2w_T
    center_3d = to_hom(center_3d_cam) @ c2w_T
    return center_3d, grid_3d - center_3d


def get_3d_points_from_depth(center, ray, depth, multi_samples: bool = False):
    """x = c + d*v (camera.py:138). depth: [B,R,S,1] when multi."""
    if multi_samples:
        center, ray = center[:, :, None], ray[:, :, None]
    return center + ray * depth


def get_coord_ref_ndc(extr_ref, intr_ref, pts_3d, inv_scale, near_far):
    """Project world points into a reference view (camera.py:150).

    extr_ref: [B,3,4] w2c; intr_ref: [B,3,3]; pts_3d: [B,R,S,3];
    inv_scale: [B,2] = (W-1, H-1); near_far: [B,2]. Returns [B,R,S,3]: xy in
    [0,1] image coordinates and z depth-normalised."""
    bs, n_rays, n_samples, _ = pts_3d.shape
    pts = pts_3d.reshape(bs, -1, 3)
    near, far = near_far[..., :1], near_far[..., 1:]
    pts_ref = to_hom(pts) @ extr_ref.transpose(-1, -2)
    pix = pts_ref @ intr_ref.transpose(-1, -2)
    xy = pix[..., :2] / pix[..., -1:] / inv_scale.reshape(bs, 1, 2)
    z = (pix[..., 2] - near) / (far - near)
    out = torch.cat([xy, z[..., None]], dim=-1)
    return out.reshape(bs, n_rays, n_samples, 3)
