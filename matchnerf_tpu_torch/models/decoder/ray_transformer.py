"""IBRNet-style multi-head attention over the depth samples of a ray
(counterpart of matchnerf_tpu/models/decoder/ray_transformer.py).

4 heads of d=4 on a 16-d token, bias-free projections, residual plus
LayerNorm(eps=1e-6). The mask fills along the QUERY axis, as the reference's
broadcast masked_fill does: a masked query row sees -1e9 everywhere, so its
attention is uniform (ray_transformer.py:41-44).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.nn import Linear
from ...ops.norm import LayerNorm


class RayAttention(nn.Module):
    def __init__(self, n_head: int = 4, d_model: int = 16, d_k: int = 4,
                 d_v: int = 4):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qs = Linear(d_model, n_head * d_k, bias=False, init="xavier")
        self.w_ks = Linear(d_model, n_head * d_k, bias=False, init="xavier")
        self.w_vs = Linear(d_model, n_head * d_v, bias=False, init="xavier")
        self.fc = Linear(n_head * d_v, d_model, bias=False, init="xavier")
        self.layer_norm = LayerNorm(d_model, eps=1e-6)

    def forward(self, x, mask=None):
        """x: [B,L,16] (query = key = value); mask: [B,L,1] floats, 0 masks
        the query row. Returns [B,L,16]."""
        B, L, _ = x.shape
        H, dk, dv = self.n_head, self.d_k, self.d_v
        q = self.w_qs(x).reshape(B, L, H, dk).transpose(1, 2)
        k = self.w_ks(x).reshape(B, L, H, dk).transpose(1, 2)
        v = self.w_vs(x).reshape(B, L, H, dv).transpose(1, 2)
        attn = torch.matmul(q / math.sqrt(dk), k.transpose(-1, -2))  # [B,H,L,L]
        if mask is not None:
            attn = torch.where(mask[:, None, :, :] == 0, -1e9, attn)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, L, H * dv)
        return self.layer_norm(self.fc(out) + x)
