"""GMFlow multi-view matching encoder (counterpart of
matchnerf_tpu/models/gmflow/gmflow.py).

ImageNet normalisation, the shared CNN backbone over all views, the
C(V,2) ordered-pair expansion, per-window sine position embedding, the
feature transformer and the two-branch upsampler. `extract_pair_features`
returns per-scale [B,P,2,h,w,C] stacks (raw 1/8 scale first, then the
upsampled scale) as the JAX package does; with `feature_upsampler` other
than "network" (configs' `none`) the encoder has no `featup_net` and the
second stack is the transformer's features again (gmflow.py:49,
:184-193). With `num_scales` 2 to 4 the backbone's trident branches give
one map per scale (gmflow.py:38-44, 81, 146-151), taken low to high
resolution, one per entry of attn_splits_list (a longer list repeats the
last); MatchNeRF's encoder has one scale.

bf16 policy (gmflow.py:110-114,195-196): with compute_dtype=bfloat16 the
weights are cast per call (ops/nn.py) and activations run in bf16, norm and
softmax statistics in f32, and the outputs are cast back to f32.

Stream sharding (gmflow.py:78-150 `stream_sharding`): with shard_streams
and several ranks, each rank runs the backbone on its share of the B*V view
streams and the transformer and upsampler on its share of the B*P*2
pair-side streams (`parallel.mesh.stream_rows`: contiguous, an uneven
share padded); the features are gathered after the backbone, after every
transformer block (cross-attention reads each stream's partner) and after
the upsampler, with a gradient (`parallel.mesh.gather_rows`). The
math is per stream, so every rank ends with the unsharded features.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.attention import shift_region_ids
from ...parallel import distributed as dist
from ...parallel import mesh
from ...ops.cosine_prior import pair_index_lists
from ...ops.posenc import sine_position_embedding_2d
from ...ops.resize import resize_bilinear_align_corners
from .backbone import CNNEncoder
from .superres import UpSampler
from .transformer import FeatureTransformer

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

__all__ = ["GMFlow", "encoder_input_hw", "extract_pair_features", "pair_index_lists",
           "normalize_images"]


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] in [0,1] -> ImageNet-normalised (gmflow.py:33)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    return (images - mean) / std


def encoder_input_hw(img_h: int, img_w: int):
    """The size the encoder's backbone sees: IBRNet's 756x1008 images are
    resized to 768x1024 (gmflow.py:120), any other size is its own. The
    feature tables are 1/8 of it (and the upsampled scale twice that)."""
    return (768, 1024) if (img_h, img_w) == (756, 1008) else (img_h, img_w)


class GMFlow(nn.Module):
    def __init__(self, feature_channels: int = 128, num_transformer_layers: int = 6,
                 ffn_dim_expansion: int = 4, feature_upsampler: str = "network",
                 upsample_factor: int = 2, num_scales: int = 1):
        super().__init__()
        self.feature_channels = feature_channels
        self.backbone = CNNEncoder(output_dim=feature_channels, num_output_scales=num_scales)
        self.transformer = FeatureTransformer(num_layers=num_transformer_layers,
                                              d_model=feature_channels,
                                              ffn_dim_expansion=ffn_dim_expansion)
        if feature_upsampler == "network":
            self.featup_net = UpSampler(n_feat=feature_channels,
                                        upsample_factor=upsample_factor)


def _add_position(feat: torch.Tensor, attn_splits: int, channels: int):
    """Add the DETR sine embedding per attention window ([B,h,w,C]); at
    one split the window is the whole map (gmflow.py:55-64)."""
    b, h, w, c = feat.shape
    pos = sine_position_embedding_2d(h // attn_splits, w // attn_splits,
                                     channels // 2, device=feat.device)
    pos = pos.repeat(attn_splits, attn_splits, 1)
    return feat + pos[None].to(feat.dtype)


def extract_pair_features(enc: GMFlow, images: torch.Tensor, attn_splits_list,
                          n_views: int, wo_self_attn: bool = False,
                          compute_dtype=None, kernel: bool = True, remat: bool = False,
                          shard_streams: bool = False):
    """images [B,V,H,W,3] in [0,1] -> list over scales of [B,P,2,h,w,C] f32.

    kernel=False runs the plain window attention even on CUDA tensors;
    remat recomputes each transformer layer in the backward; shard_streams
    splits the streams over the ranks (module docstring)."""
    b, v, img_h, img_w, _ = images.shape
    assert v == n_views
    pairs = pair_index_lists(n_views)
    n_pairs = len(pairs)
    C = enc.feature_channels
    cd = compute_dtype if compute_dtype not in (None, torch.float32) else None

    enc_h, enc_w = encoder_input_hw(img_h, img_w)
    if (enc_h, enc_w) != (img_h, img_w):
        flat = resize_bilinear_align_corners(images.reshape(b * v, img_h, img_w, 3),
                                             enc_h, enc_w)
        img_h, img_w = enc_h, enc_w
        images = flat.reshape(b, v, img_h, img_w, 3)

    net_in = normalize_images(images).reshape(b * v, img_h, img_w, 3)
    net_in = net_in.permute(0, 3, 1, 2).contiguous()
    if cd is not None:
        net_in = net_in.to(cd)
    shard_streams = shard_streams and dist.process_count() > 1
    if shard_streams:
        rows = mesh.stream_rows(b * v, net_in.device)
        feats = [mesh.gather_rows(f, b * v) for f in enc.backbone(net_in[rows])]
    else:
        feats = enc.backbone(net_in)                              # [BV,C,h,w] per scale
    # low to high resolution (gmflow.py:146-151); a list of attention splits
    # longer than the scales repeats the last scale, a shorter one leaves a
    # scale without its splits
    if len(attn_splits_list) < len(feats):
        raise ValueError(f"extract_pair_features: attn_splits_list {list(attn_splits_list)} "
                         f"names fewer than the backbone's {len(feats)} scales")
    feats = [f.permute(0, 2, 3, 1) for f in feats[::-1]]
    scales = list(range(len(feats)))
    scales += [scales[-1]] * (len(attn_splits_list) - len(scales))

    out_scales = []
    idx0 = [p[0] for p in pairs]
    idx1 = [p[1] for p in pairs]
    for attn_splits, scale in zip(attn_splits_list, scales):
        _, h, w, _ = feats[scale].shape
        feat = feats[scale].reshape(b, v, h, w, C)
        # the pairs' views stacked from slices, not gathered by a list index:
        # the gradient of a view then sums its pairs' slices in a fixed
        # order (the backward of advanced indexing adds in an order that
        # changes with the CPU's threads)
        feat0 = _add_position(torch.stack([feat[:, i] for i in idx0], 1).reshape(
            b * n_pairs, h, w, C), attn_splits, C)
        feat1 = _add_position(torch.stack([feat[:, i] for i in idx1], 1).reshape(
            b * n_pairs, h, w, C), attn_splits, C)
        # no shift mask at one split (transformer.py:108)
        rid = (shift_region_ids(h, w, attn_splits, device=feat.device)
               if attn_splits > 1 else None)
        feat0, feat1 = enc.transformer(feat0, feat1, attn_splits, region_ids=rid,
                                       wo_self_attn=wo_self_attn, kernel=kernel, remat=remat,
                                       shard_streams=shard_streams)
        out_scales.append(torch.stack([feat0, feat1], dim=1)
                          .reshape(b, n_pairs, 2, h, w, C))
        if not hasattr(enc, "featup_net"):          # feature_upsampler: none
            out_scales.append(out_scales[-1])
            continue
        merged = torch.cat([feat0, feat1], dim=0).permute(0, 3, 1, 2)
        if shard_streams:
            n = merged.shape[0]
            up = mesh.gather_rows(
                enc.featup_net(merged[mesh.stream_rows(n, merged.device)]), n)
        else:
            up = enc.featup_net(merged)
        up = up.permute(0, 2, 3, 1)
        up0, up1 = torch.chunk(up, 2, dim=0)
        uh, uw = up0.shape[1:3]
        out_scales.append(torch.stack([up0, up1], dim=1)
                          .reshape(b, n_pairs, 2, uh, uw, C))
    return [f.float() for f in out_scales]
