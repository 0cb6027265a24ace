"""Camera / pose / projection math on torch tensors.

Counterpart of matchnerf_tpu/camera.py (the eval render's subset, and the
host-side video trajectories and `get_novel_view_poses` in numpy and
scipy). Conventions are the same: a pose is a [..., 3, 4] world-to-camera
[R|t]; `legacy` pixel grids have no +0.5 centre offset, and the legacy
target-pose inverse is taken host-side in float64
(`pose_inverse_legacy_np`).
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


# ---------------------------------------------------------------------------
# host-side render-path generators (camera.py:218-292); numpy and scipy
# ---------------------------------------------------------------------------


def get_interpolate_render_path(c2ws: np.ndarray, n_views: int = 30) -> np.ndarray:
    """Euler-angle interpolation between source camera poses (camera.py:218).
    c2ws: [N,3or4,4] camera-to-world. Returns [n,4,4] float64."""
    from scipy.spatial.transform import Rotation

    N = len(c2ws)
    rotvec, positions = [], []
    rotvec_interp, positions_interp = [], []
    weight = np.linspace(1.0, 0.0, max(1, n_views // 3),
                         endpoint=False).reshape(-1, 1)
    for i in range(N):
        euler = Rotation.from_matrix(c2ws[i, :3, :3]).as_euler("xyz", degrees=True).reshape(1, 3)
        if i:
            mask = np.abs(euler - rotvec[0]) > 180
            euler[mask] += 360.0
        rotvec.append(euler)
        positions.append(c2ws[i, :3, 3:].reshape(1, 3))
        if i:
            rotvec_interp.append(weight * rotvec[i - 1] + (1.0 - weight) * rotvec[i])
            positions_interp.append(weight * positions[i - 1] + (1.0 - weight) * positions[i])
    rotvec_interp.append(weight * rotvec[-1] + (1.0 - weight) * rotvec[0])
    positions_interp.append(weight * positions[-1] + (1.0 - weight) * positions[0])

    out = []
    for rv, pos in zip(np.concatenate(rotvec_interp), np.concatenate(positions_interp)):
        c2w = np.eye(4)
        c2w[:3, :3] = Rotation.from_euler("xyz", rv, degrees=True).as_matrix()
        c2w[:3, 3:] = pos.reshape(3, 1)
        out.append(c2w)
    return np.stack(out)


def _normalize_np(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def viewmatrix(z, up, pos):
    vec2 = _normalize_np(z)
    vec0 = _normalize_np(np.cross(up, vec2))
    vec1 = _normalize_np(np.cross(vec2, vec0))
    m = np.eye(4)
    m[:3] = np.stack([vec0, vec1, vec2, pos], 1)
    return m


def poses_avg(poses):
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize_np(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return viewmatrix(vec2, up, center)


def render_path_spiral(c2w, up, rads, focal, zrate, n_rots=2, n_frames=120):
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames + 1)[:-1]:
        c = np.dot(c2w[:3, :4],
                   np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize_np(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(viewmatrix(z, up, c))
    return render_poses


def get_spiral_render_path(c2ws_all, near_far, rads_scale=0.5, n_frames=120):
    """LLFF spiral path around the average camera (camera.py:283). Returns
    [n_frames,4,4] float64."""
    c2w = poses_avg(c2ws_all)
    up = _normalize_np(c2ws_all[:, :3, 1].sum(0))
    close_depth, inf_depth = near_far
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    tt = c2ws_all[:, :3, 3] - c2w[:3, 3][None]
    rads = np.percentile(np.abs(tt), 70, 0) * rads_scale
    return np.stack(render_path_spiral(c2w, up, rads, focal, zrate=0.5, n_frames=n_frames))


def get_novel_view_poses(pose_anchor, N: int = 60, scale: float = 1.0) -> np.ndarray:
    """N poses [N,3,4] f32 in a small circular oscillation around the [3,4]
    anchor pose (camera.py:295): a rotation of arcsin(0.05 sin t) about x
    and arcsin(0.05 cos t) about y, taken about a point 4 * scale ahead
    (shifted back by 3.8 * scale), composed onto the anchor."""
    from scipy.spatial.transform import Rotation

    def comp(a, b):
        Ra, ta = a[:, :3], a[:, 3:]
        Rb, tb = b[:, :3], b[:, 3:]
        return np.concatenate([Rb @ Ra, Rb @ ta + tb], axis=-1)

    out = []
    shift1 = np.concatenate([np.eye(3), np.array([[0], [0], [-4 * scale]])], axis=-1)
    shift2 = np.concatenate([np.eye(3), np.array([[0], [0], [3.8 * scale]])], axis=-1)
    for th in np.arange(N) / N * 2 * np.pi:
        rx = Rotation.from_euler("x", np.arcsin(np.sin(th) * 0.05)).as_matrix()
        ry = Rotation.from_euler("y", np.arcsin(np.cos(th) * 0.05)).as_matrix()
        pose_rot = np.concatenate([ry @ rx, np.zeros((3, 1))], axis=-1)
        oscil = comp(comp(shift1, pose_rot), shift2)
        out.append(comp(oscil, np.asarray(pose_anchor)))
    return np.stack(out).astype(np.float32)
