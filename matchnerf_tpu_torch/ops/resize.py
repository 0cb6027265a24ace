"""Resizing primitives (counterpart of matchnerf_tpu/ops/resize.py).

The x2 upsamplers work on NCHW maps (the upsampler's convolution layout);
the align-corners resize works on [B,H,W,C] like the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .grid_sample import grid_sample_2d


def upsample_nearest_x2(x: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] -> [B,C,2H,2W] nearest neighbour."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def upsample_bilinear_x2(x: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] -> [B,C,2H,2W] bilinear, half-pixel centres (align_corners
    False), edge-clamped like jax.image.resize 'linear'."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int):
    """[B,H,W,C] -> [B,out_h,out_w,C] bilinear with align_corners=True,
    through the same grid sampler as the JAX package (resize.py:30)."""
    B = x.shape[0]
    gy = torch.linspace(-1.0, 1.0, out_h) if out_h > 1 else torch.zeros(1)
    gx = torch.linspace(-1.0, 1.0, out_w) if out_w > 1 else torch.zeros(1)
    GY, GX = torch.meshgrid(gy, gx, indexing="ij")
    grid = torch.stack([GX, GY], dim=-1)[None].to(x.device)
    grid = grid.expand(B, out_h, out_w, 2)
    return grid_sample_2d(x, grid).to(x.dtype)
