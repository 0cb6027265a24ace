"""Kernel B: the grouped-cosine matching prior of one feature scale.

Replaces matchnerf_tpu/ops/pallas_banded.py::banded_cosine_scale (the
per-ray banded Pallas kernel of the eval path). The CUDA source is
csrc/cosine_prior.cu; `cosine_prior_plain` is the same function in plain
PyTorch (the JAX direct path: `grid_sample` on each view, then
`_grouped_cosine`, matchnerf.py:389-402).

For every sample and every view it bilinearly samples the view's unpacked
table [V,h,w,(V-1)*C] (align_corners, border clamp), multiplies by the
per-(view, channel) dequantisation scale after interpolation, then for each
pair (i, j) of `pair_index_lists` takes the grouped cosine of view i's chunk
j-1 against view j's chunk i (eps 1e-8 on each norm) and averages over the
pairs. Output [R,S,G] f32. The JAX package's run-length dedup (`kt`
buckets) and 2x2 packing only existed to save TPU gathers and are not
carried.
"""
from __future__ import annotations

import torch

from .. import kernels
from .grid_sample import grid_sample_2d

COUNTER = kernels.LaunchCounter("cosine_prior")


def pair_index_lists(n_views: int):
    """All ordered pairs (a, b) with a < b (gmflow.py:28)."""
    return [(a, b) for a in range(n_views - 1) for b in range(a + 1, n_views)]


def grouped_cosine(a, b, n_groups: int, eps: float = 1e-8):
    """[...,C] x [...,C] -> [...,G] cosine per channel-major group
    (matchnerf.py:207)."""
    ag = a.reshape(*a.shape[:-1], n_groups, a.shape[-1] // n_groups)
    bg = b.reshape(*b.shape[:-1], n_groups, b.shape[-1] // n_groups)
    dot = (ag * bg).sum(-1)
    na = torch.clamp_min(torch.linalg.norm(ag, dim=-1), eps)
    nb = torch.clamp_min(torch.linalg.norm(bg, dim=-1), eps)
    return dot / (na * nb)


def cosine_prior_plain(table, grids, scales, n_groups: int):
    """table [V,h,w,(V-1)C] (int8/f32/bf16); grids [V,R,S,2] f32; scales
    [V,(V-1)C] f32 or None -> [R,S,G] f32."""
    if table.is_cuda:
        COUNTER.plain_on_cuda += 1
    V = table.shape[0]
    C = table.shape[-1] // (V - 1)
    sampled = []
    for v in range(V):
        s = grid_sample_2d(table[v:v + 1], grids[v:v + 1])[0]       # [R,S,(V-1)C]
        if scales is not None:
            s = s * scales[v]
        sampled.append(s)
    pairs = pair_index_lists(V)
    total = None
    for (i, j) in pairs:
        ca, cb = j - 1, i
        cos = grouped_cosine(sampled[i][..., ca * C:(ca + 1) * C],
                             sampled[j][..., cb * C:(cb + 1) * C], n_groups)
        total = cos if total is None else total + cos
    return total / len(pairs)


def cosine_prior(table, grids, scales, n_groups: int):
    """The kernel on CUDA tensors (V=3, C=128, int8 or f32 tables), the plain
    version on CPU tensors."""
    if table.device.type == "cpu":
        return cosine_prior_plain(table, grids, scales, n_groups)
    if not table.is_cuda:
        raise ValueError(f"cosine_prior: unsupported device {table.device}")
    if table.dtype not in (torch.int8, torch.float32):
        raise ValueError(f"cosine_prior: table dtype {table.dtype} (int8 or f32)")
    if table.dim() != 4 or table.shape[0] != 3 or table.shape[-1] != 256:
        raise ValueError(f"cosine_prior: table {tuple(table.shape)}, kernel takes [3,h,w,256]")
    V, H, W, Cc = table.shape
    C = Cc // (V - 1)
    if n_groups not in (1, 2, 4, 8, 16):
        raise ValueError(f"cosine_prior: n_groups={n_groups}, kernel takes 1, 2, 4, 8 or 16")
    if (grids.dtype != torch.float32 or grids.dim() != 4 or grids.shape[0] != V
            or grids.shape[-1] != 2 or grids.device != table.device):
        raise ValueError(f"cosine_prior: grids {tuple(grids.shape)} {grids.dtype}, "
                         f"kernel takes f32 [{V},R,S,2] on {table.device}")
    if scales is None:
        scales = torch.ones(V, Cc, dtype=torch.float32, device=table.device)
    if (scales.dtype != torch.float32 or tuple(scales.shape) != (V, Cc)
            or scales.device != table.device):
        raise ValueError(f"cosine_prior: scales {tuple(scales.shape)} {scales.dtype}, "
                         f"kernel takes f32 [{V},{Cc}]")
    for name, t in (("table", table), ("grids", grids), ("scales", scales)):
        if not t.is_contiguous():
            raise ValueError(f"cosine_prior: {name} is not contiguous")
    R, S = grids.shape[1:3]
    out = torch.empty(R, S, n_groups, dtype=torch.float32, device=table.device)
    fn = "cosine_prior_i8" if table.dtype == torch.int8 else "cosine_prior_f32"
    kernels.launch(COUNTER, fn, table.data_ptr(), grids.data_ptr(),
                   scales.data_ptr(), out.data_ptr(), V, H, W, C, n_groups,
                   R * S)
    return out
