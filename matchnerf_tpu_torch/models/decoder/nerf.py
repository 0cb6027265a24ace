"""Generic (unconditional) NeRF MLP decoder (counterpart of
matchnerf_tpu/models/decoder/nerf.py).

The reference base class's forward (models/rfdecoder/nerf.py:13-99): a
`layers_feat` MLP over the encoded point, with the encoding concatenated
AFTER the features at each layer in `skip` and one extra output channel for
the density on the last layer, then a `layers_rgb` branch over [feature,
encoded direction] when `nerf.view_dep`; TensorFlow-style Xavier-uniform
init (gain sqrt(2) before a ReLU, 1 on an output layer), zero biases. No
shipped config builds it (MatchNeRF decodes with the CondNeRF); it is the
decoder family's per-scene baseline. The encoding is the standard
pi-scaled one.

Parameter names follow the reference: `mlp_feat.{i}`, `mlp_rgb.{i}`
(weights.py::nerf_state_dict_from_jax bridges the JAX parameters).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...ops.nn import Linear, relu
from ...ops.posenc import nerf_posenc

DENSITY_ACTIVATIONS = {
    "relu_": relu, "relu": relu, "abs_": torch.abs, "abs": torch.abs,
    "sigmoid_": torch.sigmoid, "sigmoid": torch.sigmoid, "exp_": torch.exp, "exp": torch.exp,
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),   # jax.nn.softplus
}


class XavierLinear(Linear):
    """A Linear with the TensorFlow Xavier-uniform init scaled by `gain`."""

    def __init__(self, d_in: int, d_out: int, gain: float = 1.0):
        self.gain = gain
        super().__init__(d_in, d_out)

    def reset_parameters(self, generator=None):
        limit = self.gain * math.sqrt(6.0 / (self.in_features + self.out_features))
        with torch.no_grad():
            self.weight.copy_((torch.rand(self.weight.shape, generator=generator) * 2.0 - 1.0)
                              * limit)
            self.bias.zero_()


def _encoding_dims(cfg):
    posenc = cfg.decoder.posenc
    if not posenc:
        return 3, 3
    return 3 + 6 * int(posenc.L_3D), 3 + 6 * int(posenc.L_view)


class NeRF(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dec = cfg.decoder
        in_3d, in_view = _encoding_dims(cfg)
        skip = set(dec.skip)
        relu_gain = math.sqrt(2.0)
        dims = list(zip(dec.layers_feat[:-1], dec.layers_feat[1:]))
        feat = []
        for li, (k_in, k_out) in enumerate(dims):
            last = li == len(dims) - 1
            k_in = in_3d if li == 0 else k_in
            k_in += in_3d if li in skip else 0
            feat.append(XavierLinear(k_in, k_out + last, 1.0 if last else relu_gain))
        self.mlp_feat = nn.ModuleList(feat)
        dims = list(zip(dec.layers_rgb[:-1], dec.layers_rgb[1:]))
        rgb = []
        for li, (k_in, k_out) in enumerate(dims):
            if li == 0:
                k_in = dec.layers_feat[-1] + (in_view if cfg.nerf.view_dep else 0)
            rgb.append(XavierLinear(k_in, k_out, 1.0 if li == len(dims) - 1 else relu_gain))
        self.mlp_rgb = nn.ModuleList(rgb)


def apply_nerf(dec: NeRF, cfg, points_3d: torch.Tensor, ray_unit: Optional[torch.Tensor] = None,
               mode: Optional[str] = None, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
    """points_3d [..., 3] (ray_unit [..., 3] with view_dep) -> (rgb [..., 3],
    density [...]) (nerf.py:55-89). In `mode` "train" with
    nerf.density_noise_reg, the density takes noise x density_noise_reg
    before its activation: `noise` ([...], e.g. the JAX draw) or, without
    it, a standard normal draw from `generator`."""
    skip = set(cfg.decoder.skip)
    posenc = cfg.decoder.posenc
    if posenc:
        points_enc = torch.cat([points_3d, nerf_posenc(points_3d, posenc.L_3D)], dim=-1)
    else:
        points_enc = points_3d
    feat, density = points_enc, None
    last = len(dec.mlp_feat) - 1
    for li, lin in enumerate(dec.mlp_feat):
        if li in skip:
            feat = torch.cat([feat, points_enc], dim=-1)
        feat = lin(feat)
        if li == last:
            density = feat[..., 0]
            if cfg.nerf.density_noise_reg and mode == "train":
                if noise is None:
                    noise = torch.randn(density.shape, generator=generator,
                                        device=density.device)
                density = density + noise * cfg.nerf.density_noise_reg
            density = DENSITY_ACTIVATIONS[cfg.decoder.get("density_activ", "relu_")](density)
            feat = feat[..., 1:]
        feat = relu(feat)
    if cfg.nerf.view_dep:
        if ray_unit is None:
            raise ValueError("apply_nerf: nerf.view_dep needs ray_unit")
        ray_enc = (torch.cat([ray_unit, nerf_posenc(ray_unit, posenc.L_view)], dim=-1)
                   if posenc else ray_unit)
        feat = torch.cat([feat, ray_enc], dim=-1)
    for li, lin in enumerate(dec.mlp_rgb):
        feat = lin(feat)
        if li != len(dec.mlp_rgb) - 1:
            feat = relu(feat)
    return torch.sigmoid(feat), density
