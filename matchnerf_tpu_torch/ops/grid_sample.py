"""Bilinear grid sampling with torch `F.grid_sample` semantics
(align_corners=True, border clamp), counterpart of
matchnerf_tpu/ops/grid_sample.py::grid_sample_2d.

Tables are sampled UNPACKED ([B,H,W,C], four gathers per point). The JAX
package's `pack_2x2` (four taps in one row, 4x the bytes) is a TPU trade of
bytes for fewer gather indices and is not carried into the port.
"""
from __future__ import annotations

import torch


def bilinear_taps(grid: torch.Tensor, H: int, W: int):
    """grid [...,2] (x,y in [-1,1]) -> (y0, x0, y1, x1) int64 indices and
    weights (wy0, wx0, wy1, wx1), border-clamped, align_corners=True."""
    x = ((grid[..., 0] + 1.0) * 0.5 * (W - 1.0)).clamp(0.0, W - 1.0)
    y = ((grid[..., 1] + 1.0) * 0.5 * (H - 1.0)).clamp(0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    x0i = x0.long()
    y0i = y0.long()
    x1i = (x0i + 1).clamp(max=W - 1)
    y1i = (y0i + 1).clamp(max=H - 1)
    return (y0i, x0i, y1i, x1i), (1.0 - wy1, 1.0 - wx1, wy1, wx1)


def grid_sample_2d(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample `feat` [B,H,W,C] (any dtype) at `grid` [B,...,2] -> [B,...,C]
    f32, in the tap order and weight form of grid_sample.py:26."""
    B, H, W, C = feat.shape
    g = grid.reshape(B, -1, 2)
    (y0, x0, y1, x1), (wy0, wx0, wy1, wx1) = bilinear_taps(g, H, W)
    flat = feat.reshape(B, H * W, C)
    bidx = torch.arange(B, device=feat.device)[:, None]

    def tap(yi, xi):
        return flat[bidx, yi * W + xi].float()                      # [B,N,C]

    out = (tap(y0, x0) * (wy0 * wx0)[..., None]
           + tap(y0, x1) * (wy0 * wx1)[..., None]
           + tap(y1, x0) * (wy1 * wx0)[..., None]
           + tap(y1, x1) * (wy1 * wx1)[..., None])
    return out.reshape(*grid.shape[:-1], C)


def in_frustum_mask(grid: torch.Tensor) -> torch.Tensor:
    """1.0 where the grid lies strictly inside (-1, 1) on both axes
    (grid_sample.py:185)."""
    inside = (grid > -1.0) & (grid < 1.0)
    return (inside[..., 0] & inside[..., 1]).float()
