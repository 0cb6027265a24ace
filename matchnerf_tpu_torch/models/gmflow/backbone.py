"""GMFlow CNN backbone (counterpart of matchnerf_tpu/models/gmflow/backbone.py).

Stride-2 7x7 stem, three stages of two residual blocks (64, 96, 128
channels), 1x1 projection; affine-free InstanceNorm everywhere. NCHW inside
(cuDNN convolutions). One 1/8-resolution output, or with num_output_scales
2 to 4 the trident branches (backbone.py:47-99): the third stage keeps
stride 1 (a 1/4-resolution trunk) and one shared 3x3 convolution without
bias runs at strides (1, 2, 4, 8)[:num_output_scales], high to low
resolution (the reference's MultiScaleTridentConv, `trident_conv.weight`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.nn import Conv2d, kaiming_normal_, relu
from ...ops.norm import instance_norm_2d

TRIDENT_STRIDES = (1, 2, 4, 8)


class ResidualBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.conv1 = Conv2d(c_in, c_out, 3, stride=stride, padding=1, bias=False)
        self.conv2 = Conv2d(c_out, c_out, 3, stride=1, padding=1, bias=False)
        if stride != 1 or c_in != c_out:
            self.downsample = nn.Sequential(Conv2d(c_in, c_out, 1, stride=stride))
        else:
            self.downsample = None

    def forward(self, x):
        y = relu(instance_norm_2d(self.conv1(x)))
        y = relu(instance_norm_2d(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm_2d(self.downsample(x))
        return relu(x + y)


class TridentConv(nn.Module):
    """One 3x3 convolution (no bias) shared by every output scale, run at
    one stride per scale with padding 1; its weight follows the input dtype."""

    def __init__(self, channels: int, num_branch: int):
        super().__init__()
        self.strides = TRIDENT_STRIDES[:num_branch]
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))

    def reset_parameters(self, generator=None):
        kaiming_normal_(self.weight, self.weight.shape[0] * 9, generator)

    def forward(self, x):
        w = self.weight.to(x.dtype)
        return [F.conv2d(x, w, None, stride=s, padding=1) for s in self.strides]


class CNNEncoder(nn.Module):
    def __init__(self, output_dim: int = 128, num_output_scales: int = 1):
        super().__init__()
        if not 1 <= num_output_scales <= len(TRIDENT_STRIDES):
            raise ValueError(f"CNNEncoder: num_output_scales {num_output_scales}, "
                             f"takes 1 to {len(TRIDENT_STRIDES)}")
        dims = [64, 96, 128]
        stride3 = 2 if num_output_scales == 1 else 1
        self.conv1 = Conv2d(3, dims[0], 7, stride=2, padding=3, bias=False)
        self.layer1 = nn.Sequential(ResidualBlock(dims[0], dims[0], 1),
                                    ResidualBlock(dims[0], dims[0], 1))
        self.layer2 = nn.Sequential(ResidualBlock(dims[0], dims[1], 2),
                                    ResidualBlock(dims[1], dims[1], 1))
        self.layer3 = nn.Sequential(ResidualBlock(dims[1], dims[2], stride3),
                                    ResidualBlock(dims[2], dims[2], 1))
        self.conv2 = Conv2d(dims[2], output_dim, 1)
        if num_output_scales > 1:
            self.trident_conv = TridentConv(output_dim, num_output_scales)
        else:
            self.trident_conv = None

    def forward(self, x):
        """x: [B,3,H,W] -> list of [B,C,h,w] maps, high to low resolution:
        [H/8 x W/8], or the trident branches of the H/4 x W/4 trunk."""
        x = relu(instance_norm_2d(self.conv1(x)))
        x = self.conv2(self.layer3(self.layer2(self.layer1(x))))
        return [x] if self.trident_conv is None else self.trident_conv(x)
