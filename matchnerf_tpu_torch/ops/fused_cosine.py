"""Kernel F: bilinear interpolation and grouped cosine on gathered tap rows.

Replaces matchnerf_tpu/ops/pallas_cond.py::fused_interp_grouped_cosine, the
forward-only kernel of `precision.fused_cosine` (the eval and video
renders). The CUDA source is csrc/fused_cosine.cu, one template instance
per view count V = 2 to 8 and one for V = 9 to 16 that takes V at run
time, walking each sample's pairs in order;
`fused_interp_grouped_cosine_plain` is the same function in plain PyTorch.

rows [V,N,4*(V-1)*C] hold, per view and sample, the four bilinear taps
y0x0, y0x1, y1x0, y1x1 of the view's table row (`ops/grid_sample.py::
tap_rows_and_weights`); weights [V,N,2] f32 are (wx, wy). Each view's
sample is the nested lerp (t00(1-wx) + t01 wx)(1-wy) + (t10(1-wx) + t11 wx) wy
in f32 (pallas_cond.py:54-55), times the per-(view, channel) dequantisation
scale when `scales` [V,(V-1)C] is given; then for each pair (i, j) of
`pair_index_lists`, the grouped cosine of view i's chunk j-1 against view
j's chunk i (eps 1e-8 on each norm), averaged over the pairs -> [N,G] f32.

The scales are applied after interpolation, as on the unfused route: the
JAX fused route feeds raw int8 rows to its kernel and drops them, so on
int8 tables it disagrees with its own unfused route (max |d| 0.222 on the
cosines, tests/test_torch_fused_cosine.py); the port follows the unfused
route.
"""
from __future__ import annotations

import torch

from .. import kernels
from .cosine_prior import VIEWS, pair_cosine_mean

SOURCE = "matchnerf_tpu_torch/csrc/fused_cosine.cu"
COUNTER = kernels.LaunchCounter(
    "fused_cosine", source=SOURCE, replaces="matchnerf_tpu/ops/pallas_cond.py:24")
_KERNELS = {torch.int8: "fused_cosine_i8", torch.bfloat16: "fused_cosine_bf16",
            torch.float32: "fused_cosine_f32"}


def fused_interp_grouped_cosine_plain(rows, weights, n_groups: int, scales=None,
                                      piece: int = None):
    """rows [V,N,4Cc] (any dtype); weights [V,N,2] f32; scales [V,Cc] f32
    or None -> [N,G] f32. With `piece`, `piece` samples at a time (the f32
    rows of a 4096-ray chunk at V = 4 are 12.9 GB: whole, their f32 copies
    would not fit beside them on the card)."""
    if piece is not None:
        N = rows.shape[1]
        out = torch.empty(N, n_groups, dtype=torch.float32, device=rows.device)
        for n0 in range(0, N, piece):
            out[n0:n0 + piece] = fused_interp_grouped_cosine_plain(
                rows[:, n0:n0 + piece], weights[:, n0:n0 + piece], n_groups, scales)
        return out
    if rows.is_cuda:
        COUNTER.plain_on_cuda += 1
    V, N, C4 = rows.shape
    t = rows.float().reshape(V, N, 4, C4 // 4)
    wx = weights[..., 0:1]
    wy = weights[..., 1:2]
    interp = ((t[:, :, 0] * (1 - wx) + t[:, :, 1] * wx) * (1 - wy)
              + (t[:, :, 2] * (1 - wx) + t[:, :, 3] * wx) * wy)      # [V,N,Cc]
    if scales is not None:
        interp = interp * scales[:, None, :]
    return pair_cosine_mean(list(interp), n_groups)


def fused_interp_grouped_cosine(rows, weights, n_groups: int, scales=None):
    """The kernel on CUDA tensors (V = 2 to 16 views, C = 128: rows
    [V,N,512(V-1)] of int8, bf16 or f32), the plain version on CPU tensors.
    Another view count raises a ValueError that names V, before any
    launch."""
    if rows.device.type == "cpu":
        return fused_interp_grouped_cosine_plain(rows, weights, n_groups, scales)
    if rows.dim() != 3 or rows.shape[0] not in VIEWS \
            or rows.shape[2] != 512 * (rows.shape[0] - 1):
        V = rows.shape[0] if rows.dim() == 3 else None
        raise ValueError(f"fused_interp_grouped_cosine: rows {tuple(rows.shape)} (V={V} "
                         f"views), the kernel takes V = {VIEWS[0]} to {VIEWS[-1]} "
                         "views of [V,N,512(V-1)]")
    if not rows.is_cuda:
        raise ValueError(f"fused_interp_grouped_cosine: unsupported device {rows.device}")
    if rows.dtype not in _KERNELS:
        raise ValueError(f"fused_interp_grouped_cosine: rows dtype {rows.dtype} "
                         "(int8, bf16 or f32)")
    V, N, C4 = rows.shape
    Cc = C4 // 4
    if n_groups not in (1, 2, 4, 8, 16):
        raise ValueError(f"fused_interp_grouped_cosine: n_groups={n_groups}, kernel "
                         "takes 1, 2, 4, 8 or 16")
    if (weights.dtype != torch.float32 or tuple(weights.shape) != (V, N, 2)
            or weights.device != rows.device):
        raise ValueError(f"fused_interp_grouped_cosine: weights {tuple(weights.shape)} "
                         f"{weights.dtype}, kernel takes f32 [{V},{N},2] on {rows.device}")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != (V, Cc)
                               or scales.device != rows.device):
        raise ValueError(f"fused_interp_grouped_cosine: scales {tuple(scales.shape)} "
                         f"{scales.dtype}, kernel takes f32 [{V},{Cc}]")
    for name, t in (("rows", rows), ("weights", weights), ("scales", scales)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"fused_interp_grouped_cosine: {name} must be contiguous "
                             "and 16-byte aligned")
    out = torch.empty(N, n_groups, dtype=torch.float32, device=rows.device)
    kernels.launch(COUNTER, _KERNELS[rows.dtype], rows.data_ptr(), weights.data_ptr(),
                   kernels.ptr(scales), out.data_ptr(), V, Cc // (V - 1), n_groups, N)
    return out
