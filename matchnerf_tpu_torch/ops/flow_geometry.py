"""Optical-flow geometry (counterpart of matchnerf_tpu/ops/flow_geometry.py,
NHWC as there).

The GMFlow helpers of the encoder family that no entry of the port calls
(the reference's models/gmflow/geometry.py:5-96 and utils.py:110-128):
pixel grids, flow warping by bilinear sampling (align_corners=True, 'zeros'
or 'border' padding), the UnFlow forward/backward occlusion check and the
input padder to a multiple of 8.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F


def coords_grid(b: int, h: int, w: int, homogeneous: bool = False,
                device=None) -> torch.Tensor:
    """[B,H,W,2] (x, y) pixel grid; [B,H,W,3] with a ones plane when
    homogeneous."""
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    planes = [x, y] + ([torch.ones_like(x)] if homogeneous else [])
    grid = torch.stack(planes, dim=-1)
    return grid[None].expand(b, h, w, grid.shape[-1])


def generate_window_grid(h_min, h_max, w_min, w_max, len_h: int, len_w: int,
                         device=None) -> torch.Tensor:
    """[len_h, len_w, 2] (x, y) linspace grid."""
    x, y = torch.meshgrid(torch.linspace(w_min, w_max, len_w, device=device),
                          torch.linspace(h_min, h_max, len_h, device=device), indexing="xy")
    return torch.stack([x, y], dim=-1).float()


def normalize_coords(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel coordinates [..., 2] -> [-1, 1]."""
    c = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0], dtype=torch.float32,
                     device=coords.device)
    return (coords - c) / c


def _grid_sample(feature: torch.Tensor, grid: torch.Tensor, padding_mode: str):
    """matchnerf_tpu/ops/grid_sample.py::grid_sample_2d with align_corners:
    [B,H,W,C] at grid [B,...,2] (x, y in [-1, 1]); 'border' clamps the
    coordinates, 'zeros' gives taps outside the map a value of 0."""
    B, H, W, C = feature.shape
    g = grid.reshape(B, -1, 2)
    x = (g[..., 0] + 1.0) * 0.5 * (W - 1.0)
    y = (g[..., 1] + 1.0) * 0.5 * (H - 1.0)
    if padding_mode == "border":
        x = x.clamp(0.0, W - 1.0)
        y = y.clamp(0.0, H - 1.0)
    elif padding_mode != "zeros":
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = feature.reshape(B, H * W, C)
    bidx = torch.arange(B, device=feature.device)[:, None]

    def tap(yi, xi):
        vals = flat[bidx, yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()]
        if padding_mode == "zeros":
            ok = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
            vals = torch.where(ok[..., None], vals, torch.zeros_like(vals))
        return vals

    out = (tap(y0, x0) * (wy0 * wx0)[..., None] + tap(y0, x0 + 1.0) * (wy0 * wx1)[..., None]
           + tap(y0 + 1.0, x0) * (wy1 * wx0)[..., None]
           + tap(y0 + 1.0, x0 + 1.0) * (wy1 * wx1)[..., None])
    return out.reshape(*grid.shape[:-1], C)


def bilinear_sample(feature: torch.Tensor, sample_coords: torch.Tensor,
                    padding_mode: str = "zeros", return_mask: bool = False):
    """Sample [B,H,W,C] at pixel coordinates [B,H,W,2] (align_corners=True);
    with return_mask also the [B,H,W] mask of coordinates inside the map."""
    b, h, w, _ = sample_coords.shape
    x_grid = 2.0 * sample_coords[..., 0] / (w - 1) - 1.0
    y_grid = 2.0 * sample_coords[..., 1] / (h - 1) - 1.0
    out = _grid_sample(feature, torch.stack([x_grid, y_grid], dim=-1), padding_mode)
    if return_mask:
        return out, (x_grid >= -1) & (y_grid >= -1) & (x_grid <= 1) & (y_grid <= 1)
    return out


def flow_warp(feature: torch.Tensor, flow: torch.Tensor, mask: bool = False,
              padding_mode: str = "zeros"):
    """Warp [B,H,W,C] by flow [B,H,W,2]."""
    b, h, w, _ = feature.shape
    grid = coords_grid(b, h, w, device=feature.device) + flow
    return bilinear_sample(feature, grid, padding_mode=padding_mode, return_mask=mask)


def forward_backward_consistency_check(fwd_flow: torch.Tensor, bwd_flow: torch.Tensor,
                                       alpha: float = 0.01, beta: float = 0.5):
    """UnFlow occlusion masks: [B,H,W,2] flows -> (fwd_occ, bwd_occ) f32
    [B,H,W]."""
    flow_mag = torch.linalg.norm(fwd_flow, dim=-1) + torch.linalg.norm(bwd_flow, dim=-1)
    diff_fwd = torch.linalg.norm(fwd_flow + flow_warp(bwd_flow, fwd_flow), dim=-1)
    diff_bwd = torch.linalg.norm(bwd_flow + flow_warp(fwd_flow, bwd_flow), dim=-1)
    threshold = alpha * flow_mag + beta
    return (diff_fwd > threshold).float(), (diff_bwd > threshold).float()


class InputPadder:
    """Pad NHWC images to a multiple of padding_factor by edge replication
    ('sintel' centres the pad; any other mode pads the bottom)."""

    def __init__(self, dims: Sequence[int], mode: str = "sintel", padding_factor: int = 8):
        self.ht, self.wd = dims[-3:-1] if len(dims) >= 3 else dims[-2:]
        pad_ht = ((self.ht // padding_factor + 1) * padding_factor - self.ht) % padding_factor
        pad_wd = ((self.wd // padding_factor + 1) * padding_factor - self.wd) % padding_factor
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs: torch.Tensor) -> List[torch.Tensor]:
        return [F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate").permute(0, 2, 3, 1)
                for x in inputs]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        ht, wd = x.shape[-3:-1]
        l, r, t, b = self._pad
        return x[..., t:ht - b, l:wd - r, :]
