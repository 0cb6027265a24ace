"""Normalisation layers (counterpart of matchnerf_tpu/ops/norm.py).

Statistics always accumulate in f32. For f32 inputs the formulas match the
JAX package's two-pass forms; for bf16 inputs (the mixed-precision encoder)
the moments are f32 and the normalise runs in bf16, as in `norm.py:40-51`.
"""
from __future__ import annotations

import torch
from torch import nn


def instance_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch `InstanceNorm2d` defaults (no affine, eps 1e-5) on NCHW input:
    normalise each (sample, channel) over the spatial axes (norm.py:19)."""
    if x.dtype == torch.float32:
        m = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return (x - m) / torch.sqrt(var + eps)
    x32 = x.float()
    m = x32.mean(dim=(2, 3), keepdim=True)
    var = torch.square(x32 - m).mean(dim=(2, 3), keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (x - m.to(x.dtype)) * inv.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Normalise over the last dimension with f32 statistics (norm.py:74)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) / torch.sqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with the reference's parameter names (`weight`, `bias`)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
