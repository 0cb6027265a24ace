"""Kernels A and A': single-head window attention of the GMFlow encoder.

Replaces matchnerf_tpu/ops/pallas_attention.py::flash_window_attention
(the Pallas flash kernel the JAX encoder uses on a TPU for the eval
forward) and matchnerf_tpu/ops/pallas_window_attention.py::
fused_window_attention (the training kernel and its custom VJP). The CUDA
source is csrc/window_attention.cu; `window_attention_plain` is the same
function in plain PyTorch (the JAX `split_window_attention` core), and its
autograd is the plain backward.

Windows arrive already rolled and split: q, k, v are [BW, L, C]. Scores are
q.k / sqrt(C); on shifted layers -100 is then added where the region ids of
query and key differ (`region_ids` [K*K, L] int32, window w uses row
w % (K*K)) — the reference order, mask after scaling. Softmax in f32.

On CUDA tensors, `window_attention` launches the forward kernel alone when
autograd is not recording (eval), and otherwise goes through
`WindowAttentionFn`: the forward kernel also writes the per-row
logsumexp, and the backward kernels (`window_attention_backward`)
recompute the attention from it (dq, dk, dv in the input dtype; two
launches, no atomics, so the gradients are the same bits from run to run).
Both types run every product on tensor cores, with f32 accumulation,
softmax and logsumexp: bf16 on bf16 operands; f32 as split TF32, each f32
product three TF32 products (hi*hi + hi*lo + lo*hi, hi the operand rounded
to TF32 and lo the rest), for all of them: Q K^T and P V in the forward,
S, dP and dS K in the dq kernel, S^T, dP^T, P^T dO and dS^T Q in the dkv
kernel. The kernels take only 16-byte-aligned tensors: their launchers
refuse others, and the wrapper then raises.
"""
from __future__ import annotations

import math

import torch

from .. import kernels

SOURCE = "matchnerf_tpu_torch/csrc/window_attention.cu"
COUNTER = kernels.LaunchCounter(
    "window_attention", source=SOURCE,
    replaces="matchnerf_tpu/ops/pallas_attention.py:44")
BWD_COUNTER = kernels.LaunchCounter(
    "window_attention_bwd", source=SOURCE,
    replaces="matchnerf_tpu/ops/pallas_window_attention.py:243")


def attention_scores_plain(q, k, region_ids=None):
    """[BW,L,C] -> the masked, scaled scores [BW,L,L] f32."""
    bw, L, c = q.shape
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(c)
    if region_ids is not None:
        n = region_ids.shape[0]
        rid = region_ids[torch.arange(bw, device=q.device) % n]        # [BW,L]
        scores = scores + torch.where(rid[:, :, None] != rid[:, None, :],
                                      -100.0, 0.0)
    return scores


def window_attention_plain(q, k, v, region_ids=None):
    """[BW,L,C] -> [BW,L,C]; materialises the [BW,L,L] scores."""
    if q.is_cuda:
        COUNTER.plain_on_cuda += 1
    attn = torch.softmax(attention_scores_plain(q, k, region_ids), dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


def _check(q, k, v, region_ids):
    """The kernel's input contract; returns n_region_rows (0: no mask)."""
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
    if region_ids is None:
        return 0
    L = q.shape[1]
    if (region_ids.dtype != torch.int32 or region_ids.device != q.device
            or region_ids.dim() != 2 or region_ids.shape[1] != L
            or not region_ids.is_contiguous()):
        raise ValueError("window_attention: region_ids must be contiguous "
                         f"int32 [K*K, {L}] on {q.device}")
    return region_ids.shape[0]


def _suffix(t):
    return "f32" if t.dtype == torch.float32 else "bf16"


def window_attention_forward(q, k, v, region_ids=None, with_lse: bool = False):
    """The forward kernel alone on CUDA tensors: (out, lse), lse the per-row
    logsumexp f32 [BW,L] of the masked, scaled scores (None unless
    `with_lse`)."""
    n_rid = _check(q, k, v, region_ids)
    bw, L, c = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(bw, L, dtype=torch.float32, device=q.device) if with_lse else None
    kernels.launch(COUNTER, f"window_attention_{_suffix(q)}", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), kernels.ptr(region_ids), out.data_ptr(),
                   kernels.ptr(lse), bw, L, c, n_rid)
    return out, lse


def window_attention_backward(q, k, v, out, lse, dout, region_ids=None):
    """The backward kernels alone on CUDA tensors: (dq, dk, dv) in q's dtype
    from the forward's inputs, its output and logsumexp (f32 [BW,L]) and
    the output gradient."""
    dout = dout.to(q.dtype).contiguous()
    bw, L, c = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty(bw, L, dtype=torch.float32, device=q.device)
    kernels.launch(BWD_COUNTER, f"window_attention_bwd_{_suffix(q)}", q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), kernels.ptr(region_ids), out.data_ptr(),
                   dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), bw, L, c,
                   0 if region_ids is None else region_ids.shape[0])
    return dq, dk, dv


class WindowAttentionFn(torch.autograd.Function):
    """Kernel A' on CUDA tensors: saves q, k, v, out and the logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, region_ids):
        out, lse = window_attention_forward(q, k, v, region_ids, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.region_ids = region_ids
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*window_attention_backward(q, k, v, out, lse, dout, ctx.region_ids), None)


def window_attention(q, k, v, region_ids=None):
    """The kernel on CUDA tensors (f32 or bf16, C=128; with its backward
    when autograd records), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, region_ids)
    if not q.is_cuda:
        raise ValueError(f"window_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return WindowAttentionFn.apply(q, k, v, region_ids)
    return window_attention_forward(q, k, v, region_ids)[0]
