"""MatchNeRF: encoder + matching prior + conditional NeRF renderer
(counterpart of matchnerf_tpu/models/matchnerf.py, eval path).

`MatchNeRF` is the module tree (`feat_enc`, `nerf_dec`) whose state_dict
keys are the reference checkpoint's; the functions below are the eval
render: `encode`, `sample_depth`, `prepare_sampling_tables`,
`query_cond_info` and `render_rays`. Each takes `kernel` (default True):
True calls the kernel wrappers, which launch the CUDA kernels on CUDA
tensors and run the plain versions on CPU tensors; False calls the plain
versions everywhere (the all-plain reference render on the card).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from matchnerf_tpu.utils.containers import effective_precision

from .. import camera
from ..ops.cosine_prior import (cosine_prior, cosine_prior_plain,
                                pair_index_lists)
from ..ops.decoder import cond_nerf_decode, cond_nerf_decode_plain
from ..ops.grid_sample import grid_sample_2d, in_frustum_mask
from ..ops.nn import reset_parameters
from .decoder.cond_nerf import CondNeRF
from .gmflow.gmflow import GMFlow, extract_pair_features


class MatchNeRF(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.feat_enc = GMFlow(
            feature_channels=128,
            num_transformer_layers=cfg.encoder.num_transformer_layers,
            ffn_dim_expansion=4, feature_upsampler=cfg.encoder.feature_upsampler,
            upsample_factor=cfg.encoder.upsample_factor)
        self.nerf_dec = CondNeRF(cfg)


def init_matchnerf(cfg, generator: Optional[torch.Generator] = None) -> MatchNeRF:
    """A MatchNeRF with weights drawn from `generator` (on the CPU), using
    the JAX package's initialisers."""
    return reset_parameters(MatchNeRF(cfg), generator)


def _precision_get(cfg, key, default=None):
    prec = effective_precision(cfg)
    return prec.get(key, default) if hasattr(prec, "get") else default


def encode(model: MatchNeRF, cfg, ref_images: torch.Tensor,
           kernel: bool = True) -> List[torch.Tensor]:
    """ref_images [B,V,H,W,3] in [0,1] -> per-scale [B,P,2,h,w,C] f32
    (matchnerf.py:47); precision.encoder_compute_dtype picks bf16."""
    cd_name = _precision_get(cfg, "encoder_compute_dtype")
    cd = torch.bfloat16 if str(cd_name) in ("bf16", "bfloat16") else None
    return extract_pair_features(
        model.feat_enc, ref_images, list(cfg.encoder.attn_splits_list),
        n_views=cfg.n_src_views, wo_self_attn=cfg.encoder.wo_self_attn,
        compute_dtype=cd, kernel=kernel)


def sample_depth(cfg, near_far: torch.Tensor, batch_size: int, num_rays: int):
    """[B,R,S,1] evenly spaced depths (matchnerf.py:72); legacy: no shift and
    an S-1 denominator. Eval only: no stratified jitter."""
    S = cfg.nerf.sample_intvs
    legacy = cfg.nerf.legacy_coord
    rand_shift = 0.0 if legacy else 0.5
    denom = (S - 1) if legacy else S
    rand = torch.full((batch_size, num_rays, S, 1), rand_shift,
                      dtype=torch.float32, device=near_far.device)
    rand = rand + torch.arange(S, dtype=torch.float32,
                               device=near_far.device)[None, None, :, None]
    dmin = near_far[:, :1].reshape(batch_size, 1, 1, 1)
    dmax = near_far[:, 1:].reshape(batch_size, 1, 1, 1)
    depth = rand / denom * (dmax - dmin) + dmin
    if cfg.nerf.depth.param == "inverse":
        depth = 1.0 / (depth + 1e-8)
    return depth


def prepare_sampling_tables(cfg, pair_feats, ref_images, feat_dtype=None,
                            color_dtype=None):
    """Per-view feature tables and the colour table, built once per image set
    (matchnerf.py:94), UNPACKED (no 2x2 taps per row).

    View v's table concatenates, in pair order, the pair-side features it
    contributes: [B,V,h,w,(V-1)C]. feat_dtype=torch.int8 quantises per
    (view, channel): abs-max / 127, round half to even, clip at +-127; the
    scale is applied after interpolation. color_dtype=torch.uint8 stores
    round(clip(img,0,1)*255) and the sampled colours are multiplied by 1/255.

    Returns {'view_feats': [per scale [B,V,h,w,(V-1)C]],
             'view_feat_scales': [per scale [B,V,(V-1)C] or None],
             'colors': [B,V,H,W,3], 'color_scale': float or None}."""
    n_views = cfg.n_src_views
    pairs = pair_index_lists(n_views)
    view_feats, view_scales = [], []
    for feats in pair_feats:
        per_view = []
        for v in range(n_views):
            chunks = [feats[:, p_idx, 0 if v == a else 1]
                      for p_idx, (a, b) in enumerate(pairs) if v in (a, b)]
            per_view.append(torch.cat(chunks, dim=-1))
        stacked = torch.stack(per_view, dim=1)                    # [B,V,h,w,(V-1)C]
        if feat_dtype == torch.int8:
            amax = stacked.abs().amax(dim=(2, 3), keepdim=True)
            scale = torch.clamp_min(amax, 1e-12) / 127.0
            stacked = torch.clamp(torch.round(stacked / scale), -127, 127).to(torch.int8)
            view_scales.append(scale[:, :, 0, 0].contiguous())
        else:
            if feat_dtype is not None:
                stacked = stacked.to(feat_dtype)
            view_scales.append(None)
        view_feats.append(stacked.contiguous())
    color_scale = None
    colors = ref_images
    if color_dtype == torch.uint8:
        colors = torch.round(torch.clamp(ref_images, 0.0, 1.0) * 255.0).to(torch.uint8)
        color_scale = 1.0 / 255.0
    return {"view_feats": view_feats, "view_feat_scales": view_scales,
            "colors": colors.contiguous(), "color_scale": color_scale}


def project_to_views(pts_3d, ref_w2c, ref_intr, ref_near_far, img_h: int,
                     img_w: int):
    """World samples [B,R,S,3] -> per-view NDC [V,B,R,S,3] (xy in [0,1])."""
    B = pts_3d.shape[0]
    V = ref_w2c.shape[1]
    inv_scale = torch.tensor([[img_w - 1, img_h - 1]], dtype=torch.float32,
                             device=pts_3d.device).expand(B, 2)
    return torch.stack([camera.get_coord_ref_ndc(ref_w2c[:, v], ref_intr[:, v],
                                                 pts_3d, inv_scale, ref_near_far[:, v])
                        for v in range(V)], dim=0)


def query_cond_info(cfg, pts_3d, ref_w2c, ref_intr, ref_near_far, tables: dict,
                    img_h: int, img_w: int, kernel: bool = True):
    """Decoder conditioning from the source views (matchnerf.py:221).

    pts_3d [B,R,S,3] world points; ref_* [B,V,...]. Returns (cond dict with
    feat_info [B,R,S,sum(G)], color_info [B,R,S,3V], mask_info [B,R,S,V],
    all contiguous f32) and the view-0 NDC coordinates [B,R,S,3]."""
    if int(cfg.encoder.feature_sample_local_radius) > 0:
        raise NotImplementedError("feature_sample_local_radius > 0 is not ported")
    B, R, S = pts_3d.shape[:3]
    V = ref_w2c.shape[1]
    cos_n_group = cfg.encoder.cos_n_group
    cos_n_group = [cos_n_group] if isinstance(cos_n_group, int) else list(cos_n_group)

    ndc_all = project_to_views(pts_3d, ref_w2c, ref_intr, ref_near_far, img_h, img_w)
    grids = ndc_all[..., :2] * 2.0 - 1.0                          # [V,B,R,S,2]

    colors = torch.stack([grid_sample_2d(tables["colors"][:, v], grids[v])
                          for v in range(V)], dim=0)              # [V,B,R,S,3]
    if tables.get("color_scale") is not None:
        colors = colors * tables["color_scale"]
    masks = in_frustum_mask(grids)                                # [V,B,R,S]
    color_info = colors.permute(1, 2, 3, 0, 4).reshape(B, R, S, V * 3).contiguous()
    mask_info = masks.permute(1, 2, 3, 0).contiguous()

    # matching prior per scale: Kernel B when precision.banded_kernel is on
    use_kernel = kernel and bool(_precision_get(cfg, "banded_kernel", False))
    prior = cosine_prior if use_kernel else cosine_prior_plain
    feat_chunks = []
    for scale_idx, vfeats in enumerate(tables["view_feats"]):
        G = cos_n_group[scale_idx]
        scales = tables["view_feat_scales"][scale_idx]
        per_b = [prior(vfeats[b], grids[:, b].contiguous(),
                       None if scales is None else scales[b], G)
                 for b in range(B)]
        feat_chunks.append(torch.stack(per_b, dim=0))             # [B,R,S,G]
    feat_info = torch.cat(feat_chunks, dim=-1).contiguous()
    cond = {"feat_info": feat_info, "color_info": color_info, "mask_info": mask_info}
    return cond, ndc_all[0]


def render_rays(model: MatchNeRF, cfg, pix_xy, tgt_intr, tgt_c2w, tgt_near_far,
                ref_w2c, ref_intr, ref_near_far, tables: dict, img_h: int,
                img_w: int, kernel: bool = True):
    """Render rays [B,R,2] of target pixels (matchnerf.py:422). Returns
    dict(rgb [B,R,3], depth [B,R,1], opacity [B,R,1])."""
    B, R = pix_xy.shape[:2]
    center, ray = camera.get_center_and_ray(pix_xy, tgt_intr, tgt_c2w)
    depth_samples = sample_depth(cfg, tgt_near_far, B, R)
    pts_3d = camera.get_3d_points_from_depth(center, ray, depth_samples,
                                             multi_samples=True)
    cond_info, ndc_view0 = query_cond_info(cfg, pts_3d, ref_w2c, ref_intr,
                                           ref_near_far, tables, img_h, img_w,
                                           kernel=kernel)
    # reference-frame unit rays, shared by every sample of a ray
    ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    R0 = ref_w2c[:, 0, :3, :3]
    ray_unit_ref = (ray_unit @ R0.transpose(-1, -2))[:, :, None, :] \
        .expand(*pts_3d.shape[:3], 3).contiguous()

    use_kernel = kernel and bool(_precision_get(cfg, "decoder_kernel", False))
    decode = cond_nerf_decode if use_kernel else cond_nerf_decode_plain
    rgb, depth, opacity = decode(model.nerf_dec, cfg, ndc_view0.contiguous(),
                                 ray_unit_ref, cond_info, depth_samples, ray)
    return {"rgb": rgb, "depth": depth, "opacity": opacity}
