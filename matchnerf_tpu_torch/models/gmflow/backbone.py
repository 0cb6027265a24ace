"""GMFlow CNN backbone (counterpart of matchnerf_tpu/models/gmflow/backbone.py).

Stride-2 7x7 stem, three stages of two residual blocks (64, 96, 128
channels), 1x1 projection; affine-free InstanceNorm everywhere. NCHW inside
(cuDNN convolutions); single 1/8-resolution output.
"""
from __future__ import annotations

from torch import nn

from ...ops.nn import Conv2d, relu
from ...ops.norm import instance_norm_2d


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


class CNNEncoder(nn.Module):
    def __init__(self, output_dim: int = 128):
        super().__init__()
        dims = [64, 96, 128]
        self.conv1 = Conv2d(3, dims[0], 7, stride=2, padding=3, bias=False)
        self.layer1 = nn.Sequential(ResidualBlock(dims[0], dims[0], 1),
                                    ResidualBlock(dims[0], dims[0], 1))
        self.layer2 = nn.Sequential(ResidualBlock(dims[0], dims[1], 2),
                                    ResidualBlock(dims[1], dims[1], 1))
        self.layer3 = nn.Sequential(ResidualBlock(dims[1], dims[2], 2),
                                    ResidualBlock(dims[2], dims[2], 1))
        self.conv2 = Conv2d(dims[2], output_dim, 1)

    def forward(self, x):
        """x: [B,3,H,W] -> [B,C,H/8,W/8]."""
        x = relu(instance_norm_2d(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)
