"""Layers and activations (counterpart of matchnerf_tpu/ops/nn.py).

`Linear` and `Conv2d` cast their f32 weights to the input's dtype at call
time, which is the JAX package's mixed-precision policy (f32 master weights,
bf16 compute; gmflow.py:110-114) without keeping a second copy of the model.

Initialisers mirror the JAX package's choices and draw from an explicit
`torch.Generator`: kaiming-normal fan_out for backbone convolutions,
xavier-uniform for transformer matrices, kaiming-normal fan_in for decoder
linears; biases start at zero.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def relu(x):
    return torch.clamp_min(x, 0.0)


def leaky_relu(x, negative_slope: float = 0.2):
    return torch.where(x >= 0, x, x * negative_slope)


def gelu(x):
    """Exact erf GELU in the same form as nn.py:59."""
    return 0.5 * x * (1.0 + torch.erf(
        x / torch.tensor(math.sqrt(2.0), dtype=x.dtype, device=x.device)))


def gelu_tanh(x):
    """GELU in its tanh form, as jax.nn.gelu's default (approximate=True)
    computes it: x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


ACTIVATIONS = {"ReLU": relu, "ELU": F.elu, "GELU": gelu}
# the decoder's raytrans_act: JAX's CondNeRF maps GELU to jax.nn.gelu, whose
# default is the tanh form (the encoder's GELU above is the erf form)
DECODER_ACTIVATIONS = {"ReLU": relu, "ELU": F.elu, "GELU": gelu_tanh}


class Activation(nn.Module):
    def __init__(self, name: str = "ReLU", table=None):
        super().__init__()
        self.name = name or "ReLU"
        self.fn = (ACTIVATIONS if table is None else table)[self.name]

    def forward(self, x):
        return self.fn(x)


def kaiming_normal_(w: torch.Tensor, fan: int, generator=None,
                    gain: float = math.sqrt(2.0)):
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator) * (gain / math.sqrt(fan)))


def xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int, generator=None):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=generator) * 2.0 - 1.0) * limit)


class Linear(nn.Linear):
    """nn.Linear whose weight follows the input dtype; `init` picks the
    JAX package's initialiser ('kaiming_fan_in' or 'xavier')."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 init: str = "kaiming_fan_in"):
        self.init = init
        super().__init__(d_in, d_out, bias=bias)

    def reset_parameters(self, generator=None):
        if self.init == "xavier":
            xavier_uniform_(self.weight, self.in_features, self.out_features,
                            generator)
        else:
            kaiming_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv2d(nn.Conv2d):
    """nn.Conv2d (NCHW) whose weight follows the input dtype; kaiming-normal
    fan_out initialisation."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__(c_in, c_out, k, stride=stride, padding=padding,
                         bias=bias)

    def reset_parameters(self, generator=None):
        fan = self.out_channels * self.kernel_size[0] * self.kernel_size[1]
        kaiming_normal_(self.weight, fan, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding)


def reset_parameters(module: nn.Module, generator=None) -> nn.Module:
    """Re-initialise every layer of `module` in registration order from
    `generator` (a seeded torch.Generator makes the weights reproducible)."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module
