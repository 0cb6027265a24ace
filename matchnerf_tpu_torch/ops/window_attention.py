"""Kernel A: single-head window attention of the GMFlow encoder.

Replaces matchnerf_tpu/ops/pallas_attention.py::flash_window_attention
(the Pallas flash kernel the JAX encoder uses on a TPU). The CUDA source is
csrc/window_attention.cu; `window_attention_plain` is the same function in
plain PyTorch (the JAX `split_window_attention` core).

Windows arrive already rolled and split: q, k, v are [BW, L, C]. Scores are
q.k / sqrt(C); on shifted layers -100 is then added where the region ids of
query and key differ (`region_ids` [K*K, L] int32, window w uses row
w % (K*K)) — the reference order, mask after scaling. Softmax in f32.
"""
from __future__ import annotations

import math

import torch

from .. import kernels

COUNTER = kernels.LaunchCounter("window_attention")


def window_attention_plain(q, k, v, region_ids=None):
    """[BW,L,C] -> [BW,L,C]; materialises the [BW,L,L] scores."""
    if q.is_cuda:
        COUNTER.plain_on_cuda += 1
    bw, L, c = q.shape
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(c)
    if region_ids is not None:
        n = region_ids.shape[0]
        rid = region_ids[torch.arange(bw, device=q.device) % n]        # [BW,L]
        scores = scores + torch.where(rid[:, :, None] != rid[:, None, :],
                                      -100.0, 0.0)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


def window_attention(q, k, v, region_ids=None):
    """The kernel on CUDA tensors (f32 or bf16, C=128), the plain version on
    CPU tensors."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, region_ids)
    if not q.is_cuda:
        raise ValueError(f"window_attention: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"window_attention: dtype {q.dtype} (f32 or bf16)")
    if q.dim() != 3 or q.shape[-1] != 128:
        raise ValueError(f"window_attention: q {tuple(q.shape)}, kernel takes [BW,L,128]")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"window_attention: {name} {tuple(t.shape)} {t.dtype} "
                             f"does not match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"window_attention: {name} is not contiguous")
    bw, L, c = q.shape
    n_rid = 0
    if region_ids is not None:
        if (region_ids.dtype != torch.int32 or region_ids.device != q.device
                or region_ids.dim() != 2 or region_ids.shape[1] != L
                or not region_ids.is_contiguous()):
            raise ValueError("window_attention: region_ids must be contiguous "
                             f"int32 [K*K, {L}] on {q.device}")
        n_rid = region_ids.shape[0]
    out = torch.empty_like(q)
    fn = "window_attention_f32" if q.dtype == torch.float32 else "window_attention_bf16"
    kernels.launch(COUNTER, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   kernels.ptr(region_ids), out.data_ptr(), bw, L, c, n_rid)
    return out
