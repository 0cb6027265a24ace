"""Kernel C: the CondNeRF decoder with the composite folded in.

Replaces matchnerf_tpu/ops/pallas_decoder.py::cond_nerf_decode with
fold_composite=True (the eval path's decoder megakernel). The CUDA source is
csrc/cond_nerf_decode.cu; `cond_nerf_decode_plain` is the same function in
plain PyTorch (`apply_cond_nerf` followed by `composite`).

Per ray: legacy posenc (L=10) of the view-0 NDC point; 6 width-128 layers
relu((W h + b) * pts_bias(cond)) with the skip concat after layer 4; the
16-d alpha token; the 4-head ray transformer over the S samples (query-axis
mask fill where fewer than 2 views see the point, LayerNorm eps 1e-6); the
density head (optional maskfill) and the sigmoid rgb head; then the
emission-absorption composite. Returns rgb [B,R,3], depth [B,R,1],
opacity [B,R,1]. f32 throughout.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..models.decoder.cond_nerf import (CondNeRF, apply_cond_nerf, composite,
                                        raytrans_act_name)
from .posenc import ray_sinusoid_table

COUNTER = kernels.LaunchCounter("cond_nerf_decode")
_ACT_IDS = {"ReLU": 0, "ELU": 1}


def cond_nerf_decode_plain(dec: CondNeRF, cfg, points_3d, ray_unit, cond_info,
                           depth_samples, ray, setbg_opaque: bool = False):
    if points_3d.is_cuda:
        COUNTER.plain_on_cuda += 1
    rgb_s, den_s = apply_cond_nerf(dec, cfg, points_3d, ray_unit, cond_info)
    rgb, depth, opacity, _ = composite(cfg, ray, rgb_s, den_s, depth_samples,
                                       setbg_opaque=setbg_opaque)
    return rgb, depth, opacity


def pack_weights(dec: CondNeRF) -> torch.Tensor:
    """All decoder weights as one f32 vector in the kernel's order, each
    linear as its [in, out] matrix then its bias (see the .cu header)."""
    parts = []

    def lin(m):
        parts.append(m.weight.t().reshape(-1))
        if m.bias is not None:
            parts.append(m.bias.reshape(-1))

    lin(dec.pts_bias)
    for m in dec.pts_linears:
        lin(m)
    lin(dec.alpha_linear[0])
    ra = dec.ray_attention
    for m in (ra.w_qs, ra.w_ks, ra.w_vs, ra.fc):
        lin(m)
    parts += [ra.layer_norm.weight.reshape(-1), ra.layer_norm.bias.reshape(-1)]
    lin(dec.out_alpha_linear[0])
    lin(dec.out_alpha_linear[2])
    lin(dec.feature_linear)
    lin(dec.views_linears[0])
    lin(dec.rgb_linear)
    return torch.cat([p.detach().float() for p in parts]).contiguous()


def _check_supported(dec: CondNeRF, cfg, S: int):
    posenc = cfg.decoder.posenc
    problems = []
    if int(cfg.decoder.net_width) != 128 or len(dec.pts_linears) != 6:
        problems.append("net_width 128 and net_depth 6")
    if sorted(set(cfg.decoder.skip)) != [4]:
        problems.append("skip [4]")
    if not posenc or int(posenc.L_3D) != 10 or int(posenc.L_view) != 0:
        problems.append("posenc L_3D 10, L_view 0")
    if not cfg.nerf.legacy_coord:
        problems.append("legacy_coord")
    if raytrans_act_name(cfg) not in _ACT_IDS:
        problems.append("raytrans_act ReLU or ELU")
    if not 1 <= S <= 128:
        problems.append("1 <= S <= 128")
    if problems:
        raise ValueError("cond_nerf_decode: the kernel takes " + ", ".join(problems))


def cond_nerf_decode(dec: CondNeRF, cfg, points_3d, ray_unit, cond_info,
                     depth_samples, ray, setbg_opaque: bool = False):
    """The kernel on CUDA tensors, the plain version on CPU tensors.

    points_3d, ray_unit: [B,R,S,3]; cond_info: feat_info [B,R,S,Gf],
    color_info [B,R,S,3V], mask_info [B,R,S,V]; depth_samples [B,R,S,1];
    ray [B,R,3] unnormalised. All f32 and contiguous."""
    if points_3d.device.type == "cpu":
        return cond_nerf_decode_plain(dec, cfg, points_3d, ray_unit, cond_info,
                                      depth_samples, ray, setbg_opaque)
    if not points_3d.is_cuda:
        raise ValueError(f"cond_nerf_decode: unsupported device {points_3d.device}")
    B, R, S, _ = points_3d.shape
    _check_supported(dec, cfg, S)
    V = int(cfg.n_src_views)
    feat, color, mask = (cond_info["feat_info"], cond_info["color_info"],
                         cond_info["mask_info"])
    Gf = feat.shape[-1]
    expect = {"points_3d": (points_3d, (B, R, S, 3)),
              "ray_unit": (ray_unit, (B, R, S, 3)),
              "feat_info": (feat, (B, R, S, Gf)),
              "color_info": (color, (B, R, S, 3 * V)),
              "mask_info": (mask, (B, R, S, V)),
              "depth_samples": (depth_samples, (B, R, S, 1)),
              "ray": (ray, (B, R, 3))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"cond_nerf_decode: {name} {tuple(t.shape)} {t.dtype}, "
                             f"kernel takes f32 {shape}")
        if t.device != points_3d.device or not t.is_contiguous():
            raise ValueError(f"cond_nerf_decode: {name} must be contiguous on "
                             f"{points_3d.device}")
    if Gf + 4 * V != dec.pts_bias.in_features or Gf + 4 * V > 64:
        raise ValueError(f"cond_nerf_decode: conditioning width {Gf + 4 * V}")
    weights = pack_weights(dec).to(points_3d.device)
    postab = (ray_sinusoid_table(16, S, device=points_3d.device)
              if cfg.decoder.raytrans_posenc else None)
    N = B * R
    out = torch.empty(N, 5, dtype=torch.float32, device=points_3d.device)
    kernels.launch(
        COUNTER, "cond_nerf_decode_f32", points_3d.data_ptr(),
        ray_unit.data_ptr(), feat.data_ptr(), color.data_ptr(), mask.data_ptr(),
        depth_samples.data_ptr(), ray.data_ptr(), weights.data_ptr(),
        kernels.ptr(postab), out.data_ptr(), N, S, Gf, V,
        _ACT_IDS[raytrans_act_name(cfg)], int(bool(cfg.decoder.density_maskfill)),
        int(bool(cfg.nerf.wo_render_interval)), int(bool(setbg_opaque)))
    out = out.reshape(B, R, 5)
    return out[..., 0:3], out[..., 3:4], out[..., 4:5]
