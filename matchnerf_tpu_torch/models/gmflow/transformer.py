"""GMFlow feature transformer (counterpart of
matchnerf_tpu/models/gmflow/transformer.py).

Each block runs self-attention then cross-attention + FFN with single-head
split-window attention, shifted by half a window on odd layers. The two
views of each pair are stacked on the batch axis, and the partner half is
swapped after every block (transformer.py:94-139). With `remat`
(precision.remat_encoder) each attention layer runs under
`torch.utils.checkpoint` while autograd records: the backward recomputes
the layer from its inputs (its window attention through A''s forward
once more) instead of keeping its activations, as the JAX
package's `jax.checkpoint` of each layer does (transformer.py:122-126).
With `shard_streams` each rank runs the blocks on its share of the stacked
streams (`parallel.mesh.stream_rows`) and gathers them after every block,
where the partner half is swapped.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.attention import split_window_attention
from ...ops.nn import Activation, Linear
from ...ops.norm import LayerNorm
from ...parallel import mesh


class TransformerLayer(nn.Module):
    def __init__(self, d_model: int = 128, ffn_dim_expansion: int = 4,
                 no_ffn: bool = False):
        super().__init__()
        self.q_proj = Linear(d_model, d_model, bias=False, init="xavier")
        self.k_proj = Linear(d_model, d_model, bias=False, init="xavier")
        self.v_proj = Linear(d_model, d_model, bias=False, init="xavier")
        self.merge = Linear(d_model, d_model, bias=False, init="xavier")
        self.norm1 = LayerNorm(d_model)
        if no_ffn:
            self.mlp = None
        else:
            d_in = 2 * d_model
            self.mlp = nn.Sequential(
                Linear(d_in, d_in * ffn_dim_expansion, bias=False, init="xavier"),
                Activation("GELU"),
                Linear(d_in * ffn_dim_expansion, d_model, bias=False, init="xavier"))
            self.norm2 = LayerNorm(d_model)

    def forward(self, source, target, h: int, w: int, num_splits: int,
                with_shift: bool, region_ids, kernel: bool):
        """source/target: [B, h*w, C] -> source + message."""
        b, L, c = source.shape
        query = self.q_proj(source)
        key = self.k_proj(target)
        value = self.v_proj(target)
        message = split_window_attention(
            query.reshape(b, h, w, c), key.reshape(b, h, w, c),
            value.reshape(b, h, w, c), num_splits, with_shift,
            region_ids=region_ids, kernel=kernel).reshape(b, L, c)
        message = self.norm1(self.merge(message))
        if self.mlp is not None:
            message = self.norm2(self.mlp(torch.cat([source, message], dim=-1)))
        return source + message


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int = 128, ffn_dim_expansion: int = 4):
        super().__init__()
        self.self_attn = TransformerLayer(d_model, ffn_dim_expansion, no_ffn=True)
        self.cross_attn_ffn = TransformerLayer(d_model, ffn_dim_expansion)


class FeatureTransformer(nn.Module):
    def __init__(self, num_layers: int = 6, d_model: int = 128,
                 ffn_dim_expansion: int = 4):
        super().__init__()
        self.layers = nn.ModuleList(
            [TransformerBlock(d_model, ffn_dim_expansion) for _ in range(num_layers)])

    def forward(self, feature0, feature1, num_splits: int, region_ids=None,
                wo_self_attn: bool = False, kernel: bool = True, remat: bool = False,
                shard_streams: bool = False):
        """feature0/feature1: [B,h,w,C] paired views -> enhanced pair.
        region_ids: `ops.attention.shift_region_ids(h, w, num_splits)`."""
        b, h, w, c = feature0.shape
        f0 = feature0.reshape(b, h * w, c)
        f1 = feature1.reshape(b, h * w, c)
        full = torch.cat([f0, f1], dim=0)
        concat1 = torch.cat([f1, f0], dim=0)
        rows = mesh.stream_rows(2 * b, full.device) if shard_streams else None
        concat0 = full
        if rows is not None:
            concat0, concat1 = concat0[rows], concat1[rows]
        remat = remat and torch.is_grad_enabled()

        def attn(layer, source, target, with_shift):
            args = (source, target, h, w, num_splits, with_shift, region_ids, kernel)
            if remat:
                return checkpoint(layer, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            return layer(*args)

        for i, layer in enumerate(self.layers):
            with_shift = i % 2 == 1
            if not wo_self_attn:
                concat0 = attn(layer.self_attn, concat0, concat0, with_shift)
            concat0 = attn(layer.cross_attn_ffn, concat0, concat1, with_shift)
            full = concat0 if rows is None else mesh.gather_rows(concat0, 2 * b)
            half0, half1 = torch.chunk(full, 2, dim=0)
            concat1 = torch.cat([half1, half0], dim=0)
            if rows is not None:
                concat1 = concat1[rows]
        f0, f1 = torch.chunk(full, 2, dim=0)
        return f0.reshape(b, h, w, c), f1.reshape(b, h, w, c)
