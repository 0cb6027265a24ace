"""MatchNeRF: encoder + matching prior + conditional NeRF renderer
(counterpart of matchnerf_tpu/models/matchnerf.py, eval and training paths).

`MatchNeRF` is the module tree (`feat_enc`, `nerf_dec`) whose state_dict
keys are the reference checkpoint's; the functions below are the render:
`encode`, `sample_depth`, `prepare_sampling_tables`, `query_cond_info` and
`render_rays`. Each takes `kernel` (default True): True calls the kernel
wrappers, which launch the CUDA kernels on CUDA tensors and run the plain
versions on CPU tensors; False calls the plain versions everywhere (the
all-plain reference on the card). Everything stays differentiable: with f32
tables and autograd recording (the training step), the wrappers take the
kernels' backward too (A', B', D').

The cond query follows the per-pose route the renderer measured
(`Renderer.pose_prep`): a scale whose block-union bucket `block_ut[s]` is
set takes Kernel D on int8 and bf16 tables or D' on f32 tables where it
fits (ops/block_cosine_prior.py::takes_table), the others Kernel B; the colours take Kernel
E (ops/supercell_color.py) when `color_ut` is set and the supercell table
exists, the gather otherwise. With `fused_cosine` (precision.fused_cosine,
eval and video renders, B == 1) every feature scale takes Kernel F
(ops/fused_cosine.py) on the gathered tap rows instead, before the block
and per-ray routes, as matchnerf.py:311-334 does. A scale with int4 tables
(uint8, eval only) takes Kernel B's int4 form on every route, or the plain
twin with banded_kernel and block_kernel off (matchnerf.py:319-388).

With `encoder.feature_sample_local_radius` > 0 no feature table is built
(matchnerf.py:307-311, renderer.py:743, train_step.py:156): the features are
sampled from each pair's maps with the local-radius window
(`ops.grid_sample.sample_features_by_grid`) and the colours from the f32
source images, so no prior kernel and no colour kernel runs on that route.
With `nerf.view_dep: false` the decoder is the plain one, with no ray
directions (matchnerf.py:444-467): Kernel C decodes the view_dep CondNeRF
only.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from .. import camera
from ..ops.block_cosine_prior import (block_cosine_prior, block_cosine_prior_plain,
                                      takes_table)
from ..ops.cosine_prior import (cosine_prior, cosine_prior_plain, grouped_cosine,
                                pair_index_lists)
from ..ops.decoder import cond_nerf_decode, cond_nerf_decode_plain, decoder_matmul_dtype
from ..ops.fused_cosine import (fused_interp_grouped_cosine,
                                fused_interp_grouped_cosine_plain)
from ..ops.grid_sample import (grid_sample_2d, in_frustum_mask, sample_features_by_grid,
                               tap_rows_and_weights)
from ..ops.nn import reset_parameters
from ..ops.supercell_color import (build_supercell_colors, supercell_color_sample,
                                   supercell_color_sample_plain)
from ..utils.containers import effective_precision
from .decoder.cond_nerf import CondNeRF, apply_cond_nerf, composite
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


def local_radius(cfg) -> int:
    """encoder.feature_sample_local_radius: > 0 takes the local-radius
    sampler and builds no feature table."""
    return int(cfg.encoder.get("feature_sample_local_radius", 0) or 0)


def _precision_get(cfg, key, default=None):
    prec = effective_precision(cfg)
    return prec.get(key, default) if hasattr(prec, "get") else default


def encode(model: MatchNeRF, cfg, ref_images: torch.Tensor,
           kernel: bool = True, shard_streams: bool = False) -> List[torch.Tensor]:
    """ref_images [B,V,H,W,3] in [0,1] -> per-scale [B,P,2,h,w,C] f32
    (matchnerf.py:47); precision.encoder_compute_dtype picks bf16,
    precision.remat_encoder recomputes the transformer layers in the
    backward; shard_streams splits the encoder's streams over the ranks
    (`gmflow.extract_pair_features`; the JAX `stream_sharding`)."""
    cd_name = _precision_get(cfg, "encoder_compute_dtype")
    cd = torch.bfloat16 if str(cd_name) in ("bf16", "bfloat16") else None
    return extract_pair_features(
        model.feat_enc, ref_images, list(cfg.encoder.attn_splits_list),
        n_views=cfg.n_src_views, wo_self_attn=cfg.encoder.wo_self_attn,
        compute_dtype=cd, kernel=kernel,
        remat=bool(_precision_get(cfg, "remat_encoder", False)),
        shard_streams=shard_streams)


def sample_depth(cfg, near_far: torch.Tensor, batch_size: int, num_rays: int,
                 stratified: bool = False, generator: Optional[torch.Generator] = None,
                 rand: Optional[torch.Tensor] = None):
    """[B,R,S,1] depths (matchnerf.py:72); legacy: no shift and an S-1
    denominator. Evenly spaced, or with `stratified` a uniform jitter in
    [0, 1) per sample: drawn from `generator` (a torch.Generator on the
    device), or `rand` [B,R,S,1] when the caller supplies the draw."""
    S = cfg.nerf.sample_intvs
    legacy = cfg.nerf.legacy_coord
    rand_shift = 0.0 if legacy else 0.5
    denom = (S - 1) if legacy else S
    shape = (batch_size, num_rays, S, 1)
    if not stratified:
        rand = torch.full(shape, rand_shift, dtype=torch.float32, device=near_far.device)
    elif rand is None:
        rand = torch.rand(shape, generator=generator, dtype=torch.float32,
                          device=near_far.device)
    elif tuple(rand.shape) != shape:
        raise ValueError(f"sample_depth: rand {tuple(rand.shape)}, expected {shape}")
    rand = rand + torch.arange(S, dtype=torch.float32,
                               device=near_far.device)[None, None, :, None]
    dmin = near_far[:, :1].reshape(batch_size, 1, 1, 1)
    dmax = near_far[:, 1:].reshape(batch_size, 1, 1, 1)
    depth = rand / denom * (dmax - dmin) + dmin
    if cfg.nerf.depth.param == "inverse":
        depth = 1.0 / (depth + 1e-8)
    return depth


def is_int4(dtype) -> bool:
    """Whether a table dtype of `prepare_sampling_tables` names int4 tables
    ("int4", "int4pXX.X")."""
    return isinstance(dtype, str) and dtype.startswith("int4")


def abs_percentile(x, pct: float):
    """x [B,V,h,w,C] -> [B,V,C] f32: the pct percentile of |x| over the h*w
    cells of each (view, channel), as jnp.percentile's default linear
    method (jax reductions.py `_quantile`: position pct / 100 * (n - 1),
    the order statistics at its floor and ceil weighted by 1 - frac and
    frac) runs once XLA has compiled it on the CPU, in f32: the position as
    pct * (f32(1/100) * (n - 1)) (the division by a constant becomes a
    multiply by its reciprocal, and the two constants fold), the two terms
    summed in one multiply-add, low * (1 - frac) + (high * frac) rounded
    once (`fma_f32`). The order statistics come from torch.kthvalue, which
    takes any size: torch.quantile interpolates in its own order and
    refuses a flattened input past 2^24 elements (a V = 4 DTU scale-1 map
    holds 21 M)."""
    B, V, h, w, C = x.shape
    n = h * w
    a = x.abs().reshape(B, V, n, C)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    pos = f32(pct) * ((f32(1.0) / 100) * f32(n - 1))
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1 - w_high
    lo = min(max(int(low), 0), n - 1)
    hi = min(max(int(high), 0), n - 1)
    v_lo = torch.kthvalue(a, lo + 1, dim=2).values
    v_hi = v_lo if hi == lo else torch.kthvalue(a, hi + 1, dim=2).values
    return fma_f32(v_lo, w_low.to(a.device), v_hi * w_high.to(a.device))


def fma_f32(a, b, c):
    """a * b + c for f32 tensors, rounded once to f32 (a fused multiply-add
    on any device): the product is exact in f64, the f64 sum is rounded to
    odd (its error from TwoSum), and a value rounded to odd with 29 spare
    bits rounds to f32 as the exact sum would."""
    p = a.double() * b.double()
    r = c.double()
    s = p + r
    z = s - p
    err = (p - (s - z)) + (r - z)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def pack_int4(codes):
    """int4 codes [..., C] in [-8, 7] -> [..., C/2] uint8, two a byte with
    bias +8: byte k holds channel 2k in its low nibble and 2k + 1 in its
    high one, so 16 consecutive channels are 8 consecutive bytes (Kernel
    B's lane reads them as one 8-byte load). The JAX package pairs channel
    k with k + C/2 (grid_sample.py:136-146); the codes are the same."""
    b = (codes + 8).to(torch.uint8)
    return (b[..., 0::2] | (b[..., 1::2] << 4)).contiguous()


def prepare_sampling_tables(cfg, pair_feats, ref_images, feat_dtype=None,
                            color_dtype=None):
    """Per-view feature tables and the colour table, built once per image set
    (matchnerf.py:94), UNPACKED (no 2x2 taps per row): they are the JAX
    package's `view_feats_unpacked`, which the block kernel reads as well.

    View v's table concatenates, in pair order, the pair-side features it
    contributes: [B,V,h,w,(V-1)C]. feat_dtype=torch.int8 quantises per
    (view, channel): abs-max / 127, round half to even, clip at +-127; the
    scale is applied after interpolation. feat_dtype "int4" or "int4pXX.X"
    quantises per (view, channel) to the codes clip(round(x / scale), -8,
    7) with scale = abs-max / 7, or with "int4pXX.X" the XX.X percentile of
    |x| over the h*w cells / 7 (`abs_percentile`), and packs two codes + 8
    a byte (`pack_int4`): [B,V,h,w,(V-1)C/2] uint8, the int4 marker
    downstream (matchnerf.py:140-160). feat_dtype may be a per-scale list
    ([torch.int8, "int4"]). With no dtype (training), the tables are f32
    and differentiable. color_dtype=torch.uint8 stores
    round(clip(img,0,1)*255) and the sampled colours are multiplied by 1/255.
    On the block path (`precision.block_kernel`) it also builds the
    supercell colour table of Kernel E when the colours are uint8,
    `precision.color_block_kernel` is on (its default) and B == 1 (JAX
    matchnerf.py:183-196).

    Returns {'view_feats': [per scale [B,V,h,w,(V-1)C]],
             'view_feat_scales': [per scale [B,V,(V-1)C] or None],
             'colors': [B,V,H,W,3], 'color_scale': float or None,
             'colors_sc': [B,V,Hs,Ws,80] uint8 or None}.

    With the local-radius sampler (`local_radius(cfg)` > 0) there are no
    tables: 'view_feats' is empty, 'pair_feats' holds the encoder's maps and
    'colors' the f32 source images, whatever the dtypes asked."""
    if local_radius(cfg) > 0:
        return {"view_feats": [], "view_feat_scales": [], "pair_feats": list(pair_feats),
                "colors": ref_images.contiguous(), "color_scale": None, "colors_sc": None}
    n_views = cfg.n_src_views
    pairs = pair_index_lists(n_views)
    view_feats, view_scales = [], []
    per_scale = (list(feat_dtype) if isinstance(feat_dtype, (list, tuple))
                 else [feat_dtype] * len(pair_feats))
    for feats, dtype in zip(pair_feats, per_scale):
        per_view = []
        for v in range(n_views):
            chunks = [feats[:, p_idx, 0 if v == a else 1]
                      for p_idx, (a, b) in enumerate(pairs) if v in (a, b)]
            per_view.append(torch.cat(chunks, dim=-1))
        stacked = torch.stack(per_view, dim=1)                    # [B,V,h,w,(V-1)C]
        if is_int4(dtype):
            if dtype.startswith("int4p"):
                amax = abs_percentile(stacked, float(dtype[len("int4p"):]))[:, :, None, None]
            else:
                amax = stacked.abs().amax(dim=(2, 3), keepdim=True)
            scale = torch.clamp_min(amax, 1e-12) / 7.0
            codes = torch.clamp(torch.round(stacked / scale), -8, 7).to(torch.int32)
            stacked = pack_int4(codes)
            view_scales.append(scale[:, :, 0, 0].contiguous())
        elif dtype == torch.int8:
            amax = stacked.abs().amax(dim=(2, 3), keepdim=True)
            scale = torch.clamp_min(amax, 1e-12) / 127.0
            stacked = torch.clamp(torch.round(stacked / scale), -127, 127).to(torch.int8)
            view_scales.append(scale[:, :, 0, 0].contiguous())
        else:
            if dtype is not None:
                stacked = stacked.to(dtype)
            view_scales.append(None)
        view_feats.append(stacked.contiguous())
    color_scale = None
    colors_sc = None
    colors = ref_images
    if color_dtype == torch.uint8:
        colors = torch.round(torch.clamp(ref_images, 0.0, 1.0) * 255.0).to(torch.uint8)
        color_scale = 1.0 / 255.0
        B, V, H, W, _ = colors.shape
        if (B == 1 and bool(_precision_get(cfg, "block_kernel", False))
                and bool(_precision_get(cfg, "color_block_kernel", True))):
            colors_sc = build_supercell_colors(colors.reshape(B * V, H, W, 3))
            colors_sc = colors_sc.reshape(B, V, *colors_sc.shape[1:])
    return {"view_feats": view_feats, "view_feat_scales": view_scales,
            "colors": colors.contiguous(), "color_scale": color_scale,
            "colors_sc": colors_sc}


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


FUSED_CHUNK_RAYS = 8192    # rays per row gather of the fused route at V <= 3


def fused_chunk_rays(n_views: int) -> int:
    """Rays per row gather of the fused route at n_views views: a chunk's
    rows, V x 4(V-1) table rows a sample, stay at or under their size at
    V = 3 (24 rows a sample: 3.2 GB of int8 rows at S = 128), in multiples
    of 8 rays: 8192 at V <= 3, 4096 at V = 4, 872 at V = 8."""
    rows = n_views * (n_views - 1)
    return FUSED_CHUNK_RAYS if rows <= 6 else max(1, FUSED_CHUNK_RAYS * 6 // rows // 8 * 8)


def gather_tap_rows(table, grids):
    """Kernel F's inputs: table [V,h,w,Cc]; grids [V,r,S,2] -> the tap rows
    of every view [V,r*S,4Cc] in the table's dtype, and weights [V,r*S,2]."""
    V, r, S = grids.shape[:3]
    Cc = table.shape[-1]
    rows = torch.empty(V, r * S, 4 * Cc, dtype=table.dtype, device=table.device)
    weights = torch.stack([tap_rows_and_weights(table[v], grids[v], out=rows[v])[1]
                           for v in range(V)], dim=0)
    return rows, weights


def fused_cosine_scale(table, grids, scales, n_groups: int, kernel: bool = True):
    """The fused route of one scale: table [V,h,w,Cc]; grids [V,R,S,2];
    scales [V,Cc] or None -> [R,S,G] f32. The tap rows are gathered for at
    most `fused_chunk_rays(V)` rays at a time (3.2 GB of int8 rows at
    S = 128 and every V), then reduced by Kernel F (or its plain version)."""
    fn = fused_interp_grouped_cosine if kernel else fused_interp_grouped_cosine_plain
    S = grids.shape[2]
    chunk = fused_chunk_rays(grids.shape[0])
    outs = []
    for r0 in range(0, grids.shape[1], chunk):
        rows, weights = gather_tap_rows(table, grids[:, r0:r0 + chunk])
        outs.append(fn(rows, weights, n_groups, scales).reshape(-1, S, n_groups))
        del rows
    return torch.cat(outs, dim=0)


def query_cond_info(cfg, pts_3d, ref_w2c, ref_intr, ref_near_far, tables: dict,
                    img_h: int, img_w: int, kernel: bool = True,
                    block_ut: Optional[tuple] = None,
                    color_ut: Optional[int] = None, fused_cosine: bool = False):
    """Decoder conditioning from the source views (matchnerf.py:221).

    pts_3d [B,R,S,3] world points; ref_* [B,V,...]. block_ut: per-scale
    block-union buckets (None, or None at a scale, for Kernel B); color_ut:
    the supercell-union bucket (None for the colour gather); both from
    `Renderer.pose_prep` for this pose, and only for B == 1 with the rays of
    consecutive 8-pixel blocks. fused_cosine: every feature scale but an
    int4 one takes Kernel F when B == 1 (matchnerf.py:311). Returns (cond dict with feat_info
    [B,R,S,sum(G)], color_info [B,R,S,3V], mask_info [B,R,S,V], all
    contiguous f32) and the view-0 NDC coordinates [B,R,S,3]. With the
    local-radius sampler (`local_radius(cfg)` > 0) `tables` holds
    'pair_feats' and the features are sampled per pair
    (matchnerf.py:402-412), whatever the route arguments."""
    B, R, S = pts_3d.shape[:3]
    V = ref_w2c.shape[1]
    cos_n_group = cfg.encoder.cos_n_group
    cos_n_group = [cos_n_group] if isinstance(cos_n_group, int) else list(cos_n_group)

    ndc_all = project_to_views(pts_3d, ref_w2c, ref_intr, ref_near_far, img_h, img_w)
    grids = ndc_all[..., :2] * 2.0 - 1.0                          # [V,B,R,S,2]

    colors_sc = tables.get("colors_sc")
    if color_ut is not None and colors_sc is not None and B == 1:
        # Kernel E: colours from the supercell table -> [R,S,3V] on 0-255
        sample = supercell_color_sample if kernel else supercell_color_sample_plain
        color_info = sample(colors_sc[0], grids[:, 0].contiguous(), img_h, img_w)[None]
        if tables.get("color_scale") is not None:
            color_info = color_info * tables["color_scale"]
    else:
        colors = torch.stack([grid_sample_2d(tables["colors"][:, v], grids[v])
                              for v in range(V)], dim=0)          # [V,B,R,S,3]
        if tables.get("color_scale") is not None:
            colors = colors * tables["color_scale"]
        color_info = colors.permute(1, 2, 3, 0, 4).reshape(B, R, S, V * 3)
    color_info = color_info.contiguous()
    masks = in_frustum_mask(grids)                                # [V,B,R,S]
    mask_info = masks.permute(1, 2, 3, 0).contiguous()

    if local_radius(cfg) > 0:
        cond = {"feat_info": local_feature_info(cfg, tables["pair_feats"], grids,
                                                cos_n_group),
                "color_info": color_info, "mask_info": mask_info}
        return cond, ndc_all[0]

    # matching prior per scale: Kernel F on the fused route; else Kernel D
    # where the pose's union fits a bucket (int8 tables; bf16 tables and D'
    # on f32 tables where their staging fits: `takes_table`), else Kernel B
    # when precision.banded_kernel or block_kernel is on, else the plain
    # direct path. An int4 scale (uint8 table) takes neither F nor D, as in
    # JAX (matchnerf.py:174-177, :321): Kernel B's int4 form, or the plain
    # twin with both kernel keys off (JAX's XLA route, :383-388)
    fused = bool(fused_cosine) and B == 1
    use_kernel = kernel and (bool(_precision_get(cfg, "banded_kernel", False))
                             or bool(_precision_get(cfg, "block_kernel", False)))
    prior = cosine_prior if use_kernel else cosine_prior_plain
    block_prior = block_cosine_prior if kernel else block_cosine_prior_plain
    feat_chunks = []
    for scale_idx, vfeats in enumerate(tables["view_feats"]):
        G = cos_n_group[scale_idx]
        scales = tables["view_feat_scales"][scale_idx]
        ut = block_ut[scale_idx] if block_ut is not None else None
        if fused and vfeats.dtype != torch.uint8:
            feat_chunks.append(fused_cosine_scale(
                vfeats[0], grids[:, 0], None if scales is None else scales[0], G,
                kernel)[None])
            continue
        if ut is not None and B == 1 and takes_table(vfeats[0], scales, ut, S, G):
            feat_chunks.append(block_prior(vfeats[0], grids[:, 0].contiguous(),
                                           None if scales is None else scales[0],
                                           G, ut)[None])
            continue
        per_b = [prior(vfeats[b], grids[:, b].contiguous(),
                       None if scales is None else scales[b], G)
                 for b in range(B)]
        feat_chunks.append(torch.stack(per_b, dim=0))             # [B,R,S,G]
    feat_info = torch.cat(feat_chunks, dim=-1).contiguous()
    cond = {"feat_info": feat_info, "color_info": color_info, "mask_info": mask_info}
    return cond, ndc_all[0]


def local_feature_info(cfg, pair_feats, grids, cos_n_group) -> torch.Tensor:
    """The matching prior of the local-radius route: for each scale and pair
    (i, j), the grouped cosine of side 0 sampled on view i's grid against
    side 1 on view j's, averaged over the pairs (matchnerf.py:402-412).
    pair_feats: per scale [B,P,2,h,w,C]; grids [V,B,R,S,2] -> [B,R,S,sum(G)]."""
    r = local_radius(cfg)
    d = int(cfg.encoder.get("feature_sample_local_dilation", 1) or 1)
    pairs = pair_index_lists(len(grids))
    chunks = []
    for scale_idx, feats in enumerate(pair_feats):
        per_pair = []
        for p_idx, (i, j) in enumerate(pairs):
            fa = sample_features_by_grid(feats[:, p_idx, 0], grids[i], r, d)
            fb = sample_features_by_grid(feats[:, p_idx, 1], grids[j], r, d)
            per_pair.append(grouped_cosine(fa, fb, cos_n_group[scale_idx]))
            del fa, fb
        chunks.append(torch.stack(per_pair, dim=0).mean(dim=0))
    return torch.cat(chunks, dim=-1).contiguous()


def render_rays(model: MatchNeRF, cfg, pix_xy, tgt_intr, tgt_c2w, tgt_near_far,
                ref_w2c, ref_intr, ref_near_far, tables: dict, img_h: int,
                img_w: int, kernel: bool = True,
                block_ut: Optional[tuple] = None, color_ut: Optional[int] = None,
                stratified: bool = False, generator: Optional[torch.Generator] = None,
                depth_rand: Optional[torch.Tensor] = None, fused_cosine: bool = False,
                setbg_opaque: bool = False):
    """Render rays [B,R,2] of target pixels (matchnerf.py:422); block_ut,
    color_ut and fused_cosine as in `query_cond_info`; stratified,
    generator and depth_rand as `sample_depth`'s stratified, generator and
    rand; setbg_opaque composites onto a white background (Blender).
    Returns dict(rgb [B,R,3], depth [B,R,1], opacity [B,R,1]).

    On the eval decoder route (precision.decoder_kernel, autograd not
    recording) precision.decoder_matmul_dtype picks Kernel C's operand route
    (bf16: the wide products' operands rounded to bf16, as the JAX Pallas
    decoder's matmul_dtype); training ignores the key, as the JAX step does."""
    eval_decoder = (bool(_precision_get(cfg, "decoder_kernel", False))
                    and not torch.is_grad_enabled())
    B, R = pix_xy.shape[:2]
    center, ray = camera.get_center_and_ray(pix_xy, tgt_intr, tgt_c2w)
    depth_samples = sample_depth(cfg, tgt_near_far, B, R, stratified=stratified,
                                 generator=generator, rand=depth_rand)
    pts_3d = camera.get_3d_points_from_depth(center, ray, depth_samples,
                                             multi_samples=True)
    cond_info, ndc_view0 = query_cond_info(cfg, pts_3d, ref_w2c, ref_intr,
                                           ref_near_far, tables, img_h, img_w,
                                           kernel=kernel, block_ut=block_ut,
                                           color_ut=color_ut, fused_cosine=fused_cosine)
    ray_unit_ref = None
    if cfg.nerf.view_dep:
        # reference-frame unit rays, shared by every sample of a ray
        ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
        R0 = ref_w2c[:, 0, :3, :3]
        ray_unit_ref = (ray_unit @ R0.transpose(-1, -2))[:, :, None, :] \
            .expand(*pts_3d.shape[:3], 3).contiguous()

    if eval_decoder and cfg.nerf.view_dep:
        # Kernel C, or its plain version in the all-plain reference
        decode = cond_nerf_decode if kernel else cond_nerf_decode_plain
        rgb, depth, opacity = decode(model.nerf_dec, cfg, ndc_view0.contiguous(),
                                     ray_unit_ref, cond_info, depth_samples, ray,
                                     setbg_opaque=setbg_opaque,
                                     matmul_dtype=decoder_matmul_dtype(cfg))
    else:
        # the plain decoder: Kernel C is forward-only, so a step that
        # differentiates (training) takes this path whatever the config says,
        # as the JAX training step does; so does the decoder without view
        # dependence, which JAX decodes in XLA (matchnerf.py:458-467)
        rgb_s, den_s = apply_cond_nerf(model.nerf_dec, cfg, ndc_view0, ray_unit_ref,
                                       cond_info)
        rgb, depth, opacity, _ = composite(cfg, ray, rgb_s, den_s, depth_samples,
                                           setbg_opaque=setbg_opaque)
    return {"rgb": rgb, "depth": depth, "opacity": opacity}
