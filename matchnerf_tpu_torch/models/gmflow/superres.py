"""Two-branch feature upsampler (counterpart of
matchnerf_tpu/models/gmflow/superres.py): a left branch of nearest-x2
upsample + 3x3 conv + LeakyReLU(0.2) feeding residual corrections into a
right branch of bilinear-x2 upsamples. NCHW inside.
"""
from __future__ import annotations

import math

from torch import nn

from ...ops.nn import Conv2d, leaky_relu
from ...ops.resize import upsample_bilinear_x2, upsample_nearest_x2


class UpSampler(nn.Module):
    def __init__(self, n_feat: int = 128, upsample_factor: int = 2):
        super().__init__()
        n_blocks = int(math.log2(upsample_factor))
        self.conv_ls = nn.ModuleList(
            [Conv2d(n_feat, n_feat, 3, padding=1) for _ in range(n_blocks)])
        self.conv_l2rs = nn.ModuleList(
            [Conv2d(n_feat, n_feat, 3, padding=1) for _ in range(n_blocks + 1)])

    def forward(self, x):
        """x: [B,C,H,W] -> [B,C,H*2^n,W*2^n]."""
        right_x = self.conv_l2rs[0](x)
        left_x = x
        for idx, conv_l in enumerate(self.conv_ls):
            left_x = leaky_relu(conv_l(upsample_nearest_x2(left_x)), 0.2)
            mid_x = self.conv_l2rs[idx + 1](left_x)
            right_x = upsample_bilinear_x2(right_x) + mid_x
        return right_x
