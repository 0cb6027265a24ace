"""Conditional NeRF decoder and the emission-absorption composite
(counterpart of matchnerf_tpu/models/decoder/cond_nerf.py, view-dependent
variant).

`CondNeRF` holds the reference's parameter names (`pts_linears.{i}`,
`pts_bias`, `views_linears.0`, `alpha_linear.0`, `ray_attention.*`,
`out_alpha_linear.{0,2}`, `feature_linear`, `rgb_linear`); `apply_cond_nerf`
and `composite` are the plain forward that Kernel C (ops/decoder.py) is held
against.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.nn import ACTIVATIONS, Activation, Linear, relu
from ...ops.posenc import nerf_posenc, nerf_posenc_legacy, ray_sinusoid_table
from .ray_transformer import RayAttention


def cond_feat_dim(cfg) -> int:
    """sum(cos_n_group) + V*(3+1) (cond_nerf.py:34)."""
    return int(sum(cfg.encoder.cos_n_group)) + cfg.n_src_views * 4


def raytrans_act_name(cfg) -> str:
    return cfg.decoder.get("raytrans_act", "ReLU") or "ReLU"


class CondNeRF(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        if not cfg.nerf.view_dep:
            raise NotImplementedError("the port carries the view_dep CondNeRF only")
        W = cfg.decoder.net_width
        D = cfg.decoder.net_depth
        skip = set(cfg.decoder.skip)
        posenc = cfg.decoder.posenc
        in_3d = 3 + 6 * posenc.L_3D if posenc else 3
        in_view = 3 + 6 * posenc.L_view if posenc else 3
        self.pts_linears = nn.ModuleList(
            [Linear(in_3d, W)]
            + [Linear(W + in_3d if i in skip else W, W) for i in range(D - 1)])
        self.pts_bias = Linear(cond_feat_dim(cfg), W)
        self.views_linears = nn.ModuleList([Linear(in_view + W, W // 2)])
        self.alpha_linear = nn.Sequential(Linear(W, 16))
        self.ray_attention = RayAttention()
        self.out_alpha_linear = nn.Sequential(
            Linear(16, 16), Activation(raytrans_act_name(cfg)), Linear(16, 1))
        self.feature_linear = Linear(W, W)
        self.rgb_linear = Linear(W // 2, 3)


def apply_cond_nerf(dec: CondNeRF, cfg, points_3d, ray_unit, cond_info):
    """rgb [B,R,S,3] and density [B,R,S] at the samples (cond_nerf.py:71).

    points_3d: [B,R,S,3] view-0 NDC coordinates; ray_unit: [B,R,S,3]
    reference-frame unit directions; cond_info: feat_info [B,R,S,G],
    color_info [B,R,S,3V], mask_info [B,R,S,V]."""
    skip = set(cfg.decoder.skip)
    enc_fn = nerf_posenc_legacy if cfg.nerf.legacy_coord else nerf_posenc
    posenc = cfg.decoder.posenc
    if posenc:
        points_enc = torch.cat([points_3d, enc_fn(points_3d, posenc.L_3D)], dim=-1)
    else:
        points_enc = points_3d
    input_feats = torch.cat([cond_info["feat_info"], cond_info["color_info"],
                             cond_info["mask_info"]], dim=-1)
    h = points_enc
    bias = dec.pts_bias(input_feats)
    for i, lin in enumerate(dec.pts_linears):
        h = relu(lin(h) * bias)
        if i in skip:
            h = torch.cat([points_enc, h], dim=-1)

    if posenc and posenc.L_view > 0:
        ray_enc = torch.cat([ray_unit, enc_fn(ray_unit, posenc.L_view)], dim=-1)
    else:
        ray_enc = ray_unit

    act = ACTIVATIONS[raytrans_act_name(cfg)]
    B, R, S = h.shape[:3]
    raw_alpha = act(dec.alpha_linear(h))                          # [B,R,S,16]
    if cfg.decoder.raytrans_posenc:
        raw_alpha = raw_alpha + ray_sinusoid_table(16, S, device=h.device)
    nv = cond_info["mask_info"].sum(dim=-1, keepdim=True).reshape(B * R, S, 1)
    alpha = dec.ray_attention(raw_alpha.reshape(B * R, S, 16),
                              mask=(nv > 1).float())
    alpha = relu(dec.out_alpha_linear(alpha))
    if cfg.decoder.density_maskfill:
        alpha = torch.where(nv < 1, 0.0, alpha)
    density = alpha.reshape(B, R, S)

    feature = dec.feature_linear(h)
    hv = torch.cat([feature, ray_enc], dim=-1)
    for lin in dec.views_linears:
        hv = relu(lin(hv))
    rgb = torch.sigmoid(dec.rgb_linear(hv))
    return rgb, density


def composite(cfg, ray, rgb_samples, density_samples, depth_samples,
              setbg_opaque: bool = False):
    """Emission-absorption quadrature (cond_nerf.py:155). ray [B,R,3]
    unnormalised; rgb_samples [B,R,S,3]; density [B,R,S]; depth [B,R,S,1].
    Returns rgb [B,R,3], depth [B,R,1], opacity [B,R,1], prob [B,R,S,1]."""
    ray_length = torch.linalg.norm(ray, dim=-1, keepdim=True)
    depth = depth_samples[..., 0]
    intv = depth[..., 1:] - depth[..., :-1]
    intv = torch.cat([intv, torch.full_like(intv[..., :1], 1e10)], dim=-1)
    dist = intv * ray_length
    sigma_delta = (density_samples if cfg.nerf.wo_render_interval
                   else density_samples * dist)
    alpha = 1.0 - torch.exp(-sigma_delta)
    T = torch.exp(-torch.cumsum(torch.cat(
        [torch.zeros_like(sigma_delta[..., :1]), sigma_delta[..., :-1]], dim=-1),
        dim=-1))
    prob = (T * alpha)[..., None]
    depth_out = (depth_samples * prob).sum(dim=2)
    rgb_out = (rgb_samples * prob).sum(dim=2)
    opacity = prob.sum(dim=2)
    if setbg_opaque:
        rgb_out = rgb_out + (1.0 - opacity)
    return rgb_out, depth_out, opacity, prob
