"""Bilinear grid sampling with torch `F.grid_sample` semantics
(align_corners=True, border clamp), counterpart of
matchnerf_tpu/ops/grid_sample.py::grid_sample_2d.

Tables are sampled UNPACKED ([B,H,W,C], four gathers per point). The JAX
package's `pack_2x2` (four taps in one row, 4x the bytes) is a TPU trade of
bytes for fewer gather indices and is not carried into the port: the fused
cosine route (Kernel F) gathers the four taps of each sample from the
unpacked table into the row a packed table would give
(`tap_rows_and_weights`), for the samples of one slice only.

`sample_features_by_grid` adds the local-radius sampler
(`encoder.feature_sample_local_radius` > 0; grid_sample.py:192): the mean
of the (2r+1)^2 window of dilated offsets around each point.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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


def sample_features_by_grid(feat: torch.Tensor, grid: torch.Tensor,
                            local_radius: int = 0, local_dilation: int = 1) -> torch.Tensor:
    """feat [B,H,W,C]; grid [B,...,2] -> [B,...,C] f32: `grid_sample_2d`, or
    with local_radius r > 0 the mean over the (2r+1)^2 window of pixel
    offsets (dx, dy) * local_dilation, rows (dy) outer (grid_sample.py:192).
    The offset points are renormalised by (W + (2r+1)*dilation - 1)/2 (and
    likewise in y), not by the map's (W-1)/2: the reference's arithmetic,
    kept. Each offset is one `F.grid_sample` (bilinear, border,
    align_corners: the same blend in one pass; the JAX package samples this
    route in XLA, not in a Pallas kernel); the window is summed one offset
    at a time (one [N,C] sample live, not K of them), then divided by K."""
    if local_radius <= 0:
        return grid_sample_2d(feat, grid)
    B, H, W, C = feat.shape
    src = feat.float().permute(0, 3, 1, 2).contiguous()              # [B,C,H,W]
    dev = grid.device
    c = torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0], dtype=torch.float32, device=dev)
    unnorm = grid.reshape(B, -1, 2) * c + c                         # [B,N,2] pixels
    L = 2 * local_radius + 1
    c2 = torch.tensor([(W + L * local_dilation - 1) / 2.0,
                       (H + L * local_dilation - 1) / 2.0], dtype=torch.float32, device=dev)
    total = None
    for dy in range(-local_radius, local_radius + 1):
        for dx in range(-local_radius, local_radius + 1):
            off = torch.tensor([float(dx) * local_dilation, float(dy) * local_dilation],
                               dtype=torch.float32, device=dev)
            pts = ((unnorm + off - c2) / c2)[:, :, None, :]             # [B,N,1,2]
            vals = F.grid_sample(src, pts, mode="bilinear", padding_mode="border",
                                 align_corners=True)                   # [B,C,N,1]
            total = vals if total is None else total + vals
    out = (total / float(L * L))[..., 0].transpose(1, 2)               # [B,N,C]
    return out.reshape(*grid.shape[:-1], C)


def tap_rows_and_weights(table: torch.Tensor, grid: torch.Tensor,
                         out: Optional[torch.Tensor] = None):
    """The `pack_2x2` row of each grid point and its bilinear weights
    (grid_sample.py:95 `packed_rows_and_weights` on `pack_2x2(table)`),
    from the unpacked table.

    table [H,W,C] (any dtype); grid [...,2] -> rows [N,4C] in the table's
    dtype, the taps y0x0, y0x1, y1x0, y1x1 concatenated with edge
    replication (x1 = min(x0+1, W-1), y1 = min(y0+1, H-1)), and weights
    [N,2] f32 (wx, wy), N = prod(grid.shape[:-1]). `out`, if given, is a
    contiguous [N,4C] tensor of the table's dtype that receives the rows."""
    H, W, C = table.shape
    g = grid.reshape(-1, 2)
    x = ((g[:, 0] + 1.0) * 0.5 * (W - 1.0)).clamp(0.0, W - 1.0)
    y = ((g[:, 1] + 1.0) * 0.5 * (H - 1.0)).clamp(0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    weights = torch.stack([x - x0, y - y0], dim=-1)
    x0i = x0.long()
    y0i = y0.long()
    x1i = (x0i + 1).clamp(max=W - 1)
    y1i = (y0i + 1).clamp(max=H - 1)
    idx = torch.stack([y0i * W + x0i, y0i * W + x1i, y1i * W + x0i, y1i * W + x1i],
                      dim=-1).reshape(-1)
    N = g.shape[0]
    flat = table.reshape(H * W, C)
    if out is None:
        return flat.index_select(0, idx).reshape(N, 4 * C), weights
    torch.index_select(flat, 0, idx, out=out.view(N * 4, C))
    return out, weights


def in_frustum_mask(grid: torch.Tensor) -> torch.Tensor:
    """1.0 where the grid lies strictly inside (-1, 1) on both axes
    (grid_sample.py:185)."""
    inside = (grid > -1.0) & (grid < 1.0)
    return (inside[..., 0] & inside[..., 1]).float()
