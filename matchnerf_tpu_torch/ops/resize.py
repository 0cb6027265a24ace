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


def _bilinear_x2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def bilinear_x2_adjoint(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The transpose of the x2 bilinear upsample along `dim` (length 2n ->
    n), in f32: output 2i draws 3/4 of input i and 1/4 of i - 1, output 2i +
    1 3/4 of i and 1/4 of i + 1, the taps past either end clamped onto it."""
    g = g.float()
    even, odd = g.narrow(dim, 0, g.shape[dim] // 2 * 2).unflatten(dim, (-1, 2)).unbind(dim + 1)
    n = even.shape[dim]
    r = 0.75 * (even + odd)
    quarter_prev = torch.cat([even.narrow(dim, 0, 1), odd.narrow(dim, 0, n - 1)], dim)
    quarter_next = torch.cat([even.narrow(dim, 1, n - 1), odd.narrow(dim, n - 1, 1)], dim)
    return r + 0.25 * quarter_prev + 0.25 * quarter_next


class _BilinearX2(torch.autograd.Function):
    """The x2 bilinear upsample with a backward that sums in a fixed order:
    CUDA's upsample_bilinear2d_backward adds with atomics, whose order
    changes from run to run; this one is two separable transposes in torch
    ops, so a training step repeats itself on the card."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return _bilinear_x2(x)

    @staticmethod
    def backward(ctx, g):
        return bilinear_x2_adjoint(bilinear_x2_adjoint(g, 3), 2).to(ctx.dtype)


def upsample_bilinear_x2(x: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] -> [B,C,2H,2W] bilinear, half-pixel centres (align_corners
    False), edge-clamped like jax.image.resize 'linear'. On CUDA tensors
    that autograd records, the backward is `_BilinearX2`'s fixed-order sum
    (the same forward); on the CPU torch's own, which has no atomics."""
    if x.is_cuda and torch.is_grad_enabled() and x.requires_grad:
        return _BilinearX2.apply(x)
    return _bilinear_x2(x)


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
