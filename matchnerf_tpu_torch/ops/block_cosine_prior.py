"""Kernels D and D': the grouped-cosine matching prior from one dilated
union of table rows shared by each 8-ray block.

Replaces matchnerf_tpu/ops/pallas_block_banded.py::block_banded_cosine_scale
(the eval render's block-banded Pallas kernel: Kernel D, on int8 tables
with scales and on bf16 tables without) and
::block_banded_cosine_scale_trainable (its custom VJP on f32 tables: D', an
f32 forward and a backward that sums each union row's gradient over each
walk's consecutive samples (a band of depths across the block's 8 rays) in
registers, writes each run as a record at a position fixed by the input
and sums a cell's records in that order (`table_grad`), so two runs give
the same bits, as the JAX step does; the JAX package
also reaches it on bf16 eval tables, whose forward is Kernel D's). The
CUDA source is csrc/block_cosine_prior.cu; `block_cosine_prior_plain` is
the same function in plain PyTorch, along the same union route, and its
autograd is the plain backward. Union rows are staged in passes of
`channels_per_pass` channels (int8 rows as bf16); a (ut, G) that no pass
width fits (`takes_bf16` / `takes_f32` False) takes Kernel B (B') instead.

It computes what Kernel B (ops/cosine_prior.py) computes: for every sample
the bilinear sample (align corners, border clamp) of each view's unpacked
table [V,h,w,(V-1)C], the per-(view, channel) dequantisation scale after the
interpolation, and the grouped cosine of pair (i, j) (view i's chunk j-1
against view j's chunk i, eps 1e-8 on each norm) averaged over the pairs.
Output [R,S,G] f32. The difference is the route to the taps: the rays of a
slice are adjacent pixels, so the 8 rays of a block share most table rows.
Per block and view the union of the samples' (y0, x0) cells, capped at ut,
dilated by {c, c+1, c+W, c+W+1} (every bilinear tap of every sample) and
capped at ut again, as sorted unique cells padded with -1
(`block_union_cells`): the plain version builds it with torch sorts, the
kernel in shared memory with bitmaps and popcount ranks (the same cells;
tests/test_torch_block_cosine_prior.py emulates it in numpy), and stages
those rows once per block and pass. A tap missing from an overflowed union
adds 0. Tap weights stay exact f32 (the TPU kernel rounds its stencil to
bf16).

The helpers below are the counterparts of pallas_block_banded.py's
`_cells_weights4` (its cells), `_unique_compact`, `block_union_cells`,
`block_union_size_raw` and `bucket_ut`; their integer results equal the
JAX ones exactly. `ut`, the union bucket, comes from the renderer's pose
measurement (`Renderer.pose_prep`).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .cosine_prior import (RecordCount, check_table, pair_cosine_mean,
                           table_grad_from_records)
from .grid_sample import bilinear_taps, take_rows

SOURCE = "matchnerf_tpu_torch/csrc/block_cosine_prior.cu"
# the forward's C launcher per table dtype
ENTRIES = {torch.int8: "block_cosine_prior_i8", torch.bfloat16: "block_cosine_prior_bf16",
           torch.float32: "block_cosine_prior_f32"}
COUNTER = kernels.LaunchCounter(
    "block_cosine_prior", source=SOURCE,
    replaces="matchnerf_tpu/ops/pallas_block_banded.py:413")
F32_COUNTER = kernels.LaunchCounter(
    "block_cosine_prior_f32", source=SOURCE,
    replaces="matchnerf_tpu/ops/pallas_block_banded.py:311")
BWD_COUNTER = kernels.LaunchCounter(
    "block_cosine_prior_bwd", source=SOURCE,
    replaces="matchnerf_tpu/ops/pallas_block_banded.py:311")

BLOCK_RAYS = 8
BWD_THREADS = 512                 # D''s backward: threads a block, one walk per sample group
UT_BUCKETS = (64, 96, 128, 160, 192, 256, 320, 384, 512)
MAX_SMEM = 232448                 # bytes of shared memory a block may have (sm_90)


def per_view_smem(ut: int, S: int, n_views: int) -> int:
    """Bytes of shared memory that grow with the views, in both kernels'
    layouts: each (view, sample)'s taps (uint2) and fractions (float2),
    and each view's union [ut] int32."""
    return n_views * (BLOCK_RAYS * S * 16 + ut * 4)


def fwd_smem(ut: int, S: int, cp: int, itemsize: int, hw: int = 0, n_views: int = 3) -> int:
    """Bytes of the forward kernel's dynamic shared memory (csrc LayoutFwd)
    for n_views views: the two sides' staged rows, or the union build's
    bitmaps and prefix counts of an hw-cell table where they are larger,
    then the taps, the fractions and the union."""
    staged = 2 * (ut + 1) * cp * itemsize
    scratch = (2 * n_views * ((hw + 31) // 32) + 32) * 4
    return -(-max(staged, scratch) // 16) * 16 + per_view_smem(ut, S, n_views)


def bwd_smem(ut: int, S: int, cp: int, n_views: int = 3) -> int:
    """Bytes of D''s backward's dynamic shared memory (csrc LayoutPass): two
    buffers of the two sides' f32 rows (this pass's and the next one's),
    then the taps, the fractions and the union."""
    return 4 * (ut + 1) * cp * 4 + per_view_smem(ut, S, n_views)


def channels_per_pass(ut: int, S: int, n_groups: int, backward: bool,
                      itemsize: int = 4, hw: int = 0, n_views: int = 3) -> Optional[int]:
    """Channels per staging pass of the forward kernel (itemsize 4: f32
    rows; 2: bf16 rows, which int8 tables stage as too; csrc LayoutFwd,
    whose union build needs room for bitmaps of the table's hw cells) and of
    D''s backward (f32, csrc LayoutPass, which reads the forward's union),
    for n_views source views: the widest of 128, 64, 32 whose shared memory
    fits, with each cosine group inside one pass; None when none does."""
    for cp in (128, 64, 32):
        if not 128 <= n_groups * cp <= 2048:
            continue
        total = (bwd_smem(ut, S, cp, n_views) if backward
                 else fwd_smem(ut, S, cp, itemsize, hw, n_views))
        if total <= MAX_SMEM:
            return cp
    return None


def takes_f32(ut: int, S: int, n_groups: int, hw: int = 0, n_views: int = 3) -> bool:
    """Whether D' (forward and backward) takes f32 tables of hw cells and
    n_views views at this bucket."""
    return (channels_per_pass(ut, S, n_groups, False, hw=hw, n_views=n_views) is not None
            and channels_per_pass(ut, S, n_groups, True, n_views=n_views) is not None)


def takes_bf16(ut: int, S: int, n_groups: int, hw: int = 0, n_views: int = 3) -> bool:
    """Whether Kernel D's staging of 16-bit rows (bf16 tables, and int8
    tables, whose rows it stages as bf16) and its union build over hw cells
    of n_views views fit at this bucket. At G >= 2, S = 128 and 3 views
    every bucket fits; at G = 1 (one 128-channel pass) ut >= 384 does not."""
    return channels_per_pass(ut, S, n_groups, False, itemsize=2, hw=hw,
                             n_views=n_views) is not None


def takes_table(table, scales, ut: int, S: int, n_groups: int) -> bool:
    """The route of one scale whose pose measured the union bucket `ut`:
    True for Kernel D (D'), False for Kernel B (B'). The JAX package takes
    its block kernel at every bucket (matchnerf.py:336-376: int8 tables with
    scales through `block_banded_cosine_scale`, f32 and bf16 tables without
    through `block_banded_cosine_scale_trainable`); here each table type
    takes it where the kernel's shared memory holds its staging and the
    union build's bitmaps of the table's h*w cells (int8 and bf16:
    `takes_bf16`; f32: `takes_f32`), Kernel B elsewhere. The bitmaps bound
    the table to about 236k cells at S = 128 and 170k at S = 256 (ut 512).

    int8 tables take Kernel D wherever its earlier int8 staging (one byte a
    row element, an [8S, G] f32 accumulator) fit, except at G = 1 with
    (S = 128, ut 384 and 512) and (S = 256, ut 256 to 384), where the bf16
    staging does not fit and Kernel B runs; every configuration in configs/
    has G = 2 and 8 (`cos_n_group`). The views are the table's first
    dimension: a fourth view's taps, fractions and union narrow the passes
    (V = 4 at S = 128 and G = 8 stages 64 channels from ut 320, and D' at
    ut 160 and G = 2 fits no pass)."""
    V, hw = table.shape[0], table.shape[1] * table.shape[2]
    if table.dtype == torch.int8:
        return takes_bf16(ut, S, n_groups, hw, V)
    if scales is not None:
        return False
    if table.dtype == torch.bfloat16:
        return takes_bf16(ut, S, n_groups, hw, V)
    return table.dtype == torch.float32 and takes_f32(ut, S, n_groups, hw, V)


def bucket_ut(n: int) -> Optional[int]:
    """A measured block-union size rounded up to its bucket; None when the
    union is too wide for the block kernel (pallas_block_banded.py:54)."""
    for b in UT_BUCKETS:
        if n <= b:
            return b
    return None


def base_cells(grid, H: int, W: int):
    """grid [...,2] -> [...] int32 cell y0*W + x0 of each sample's (y0, x0)
    tap, clip then floor (the cells of pallas_block_banded.py:63
    `_cells_weights4`); the unions are built from them."""
    (y0, x0, _, _), _ = bilinear_taps(grid, H, W)
    return (y0 * W + x0).to(torch.int32)


def first_of_runs(sorted_vals, sentinel: int):
    """sorted_vals [NB, L] ascending -> [NB, L] bool, True at the first of
    each run of equal values below `sentinel`: the row's distinct values."""
    keep = sorted_vals < sentinel
    keep[:, 1:] &= sorted_vals[:, 1:] != sorted_vals[:, :-1]
    return keep


def unique_compact(sorted_vals, cap: int, sentinel: int):
    """sorted_vals [NB, L] ascending -> [NB, min(cap, L)] sorted unique values
    below `sentinel`, unused slots -1 (pallas_block_banded.py:104)."""
    keep = first_of_runs(sorted_vals, sentinel)
    vals = torch.sort(torch.where(keep, sorted_vals, sentinel), dim=-1).values[:, :cap]
    return torch.where(vals < sentinel, vals, -1)


def _dilate(cells, W: int, sentinel: int):
    return torch.cat([cells, torch.clamp_max(cells + 1, sentinel),
                      torch.clamp_max(cells + W, sentinel),
                      torch.clamp_max(cells + W + 1, sentinel)], dim=-1)


def block_union_cells(cells, block_rays: int, ut: int, H: int, W: int):
    """cells [R', L] per-ray cells -> [R'/block_rays, <=ut] sorted unique
    dilated block unions, -1 padded (pallas_block_banded.py:122). The
    dilation {c, c+1, c+W, c+W+1} holds every bilinear tap of every sample;
    the sentinel H*W stands for cells past the table."""
    NB = cells.shape[0] // block_rays
    sentinel = H * W
    blk = cells.reshape(NB, -1)
    u1 = unique_compact(torch.sort(blk, dim=-1).values, ut, sentinel)
    u1s = torch.where(u1 < 0, sentinel, u1)
    dil = _dilate(u1s, W, sentinel)
    return unique_compact(torch.sort(dil, dim=-1).values, ut, sentinel)


def block_union_max(grids_v, H: int, W: int, block_rays: int = BLOCK_RAYS):
    """`block_union_size_raw` as a 0-d device tensor (no host sync): the
    distinct values of each block's dilated raw cells, uncapped, counted
    after one sort (pallas_block_banded.py:141 `_dilated_union_max`)."""
    cell = base_cells(grids_v, H, W)
    dil = _dilate(cell.reshape(-1, block_rays * cell.shape[-1]), W, H * W)
    return first_of_runs(torch.sort(dil, dim=-1).values, H * W).sum(dim=-1).max()


def block_union_size_raw(grids_v, H: int, W: int, block_rays: int = BLOCK_RAYS) -> int:
    """Max over blocks of the exact dilated union size of the raw per-sample
    cells (pallas_block_banded.py:172). grids_v [R,S,2] or [V,R,S,2]; R a
    multiple of block_rays."""
    return int(block_union_max(grids_v, H, W, block_rays))


def pad_rays(grids, block_rays: int = BLOCK_RAYS):
    """[V,R,S,2] -> [V,Rp,S,2] contiguous, Rp the next multiple of block_rays,
    the tail rays repeating the last (edge padding, pallas_block_banded.py:437)."""
    pad = (-grids.shape[1]) % block_rays
    if pad:
        grids = torch.cat([grids, grids[:, -1:].expand(-1, pad, -1, -1)], dim=1)
    return grids.contiguous()


def block_unions(grids_p, H: int, W: int, ut: int):
    """Padded grids [V,Rp,S,2] -> the per-(view, block) unions [V*NB, ut]
    int32 (view-major, -1 padded to exactly ut columns)."""
    V, Rp, S = grids_p.shape[:3]
    cell = base_cells(grids_p, H, W)
    u = block_union_cells(cell.reshape(V * Rp, S), BLOCK_RAYS, ut, H, W)
    if u.shape[1] < ut:
        u = torch.nn.functional.pad(u, (0, ut - u.shape[1]), value=-1)
    return u.contiguous()


def union_positions(unions, cells, sentinel: int):
    """Row of each cell in its block's sorted union: unions [NB, ut] (-1
    padded), cells [NB, L] -> (pos [NB, L] int64 clamped to the union,
    found [NB, L] bool)."""
    keys = torch.where(unions < 0, sentinel, unions)
    pos = torch.searchsorted(keys, cells.to(keys.dtype).contiguous())
    pos = torch.clamp_max(pos, keys.shape[1] - 1)
    return pos, torch.gather(keys, 1, pos) == cells


def block_cosine_prior_plain(table, grids, scales, n_groups: int, ut: int):
    """table [V,h,w,(V-1)C] (int8, bf16 or f32); grids [V,R,S,2] f32; scales
    [V,(V-1)C] f32 or None; ut the union bucket -> [R,S,G] f32.

    The union route in torch ops: gather each block's union rows, find each
    tap by `searchsorted`, interpolate in f32 one tap and one view at a time
    (the [V,R,S,4,(V-1)C] f32 taps of a 20480-ray slice would be ~32 GB).
    A tap missing from a union (only when a union overflows `ut`) adds 0."""
    if table.is_cuda:
        COUNTER.plain_on_cuda += 1
    V, H, W, Cc = table.shape
    R, S = grids.shape[1:3]
    gp = pad_rays(grids)
    NB = gp.shape[1] // BLOCK_RAYS
    unions = block_unions(gp, H, W, ut).view(V, NB, ut)
    blocks = torch.arange(NB, device=table.device)[:, None]
    sampled = []
    for v in range(V):
        rows = take_rows(table[v].reshape(H * W, Cc),
                         torch.clamp_min(unions[v], 0).long().reshape(-1))  # [NB*ut,Cc]
        (y0, x0, y1, x1), (wy0, wx0, wy1, wx1) = bilinear_taps(gp[v], H, W)
        acc = None
        for yi, xi, w in ((y0, x0, wy0 * wx0), (y0, x1, wy0 * wx1),
                          (y1, x0, wy1 * wx0), (y1, x1, wy1 * wx1)):
            cells = (yi * W + xi).reshape(NB, BLOCK_RAYS * S)
            pos, found = union_positions(unions[v], cells, H * W)
            w = torch.where(found, w.reshape(NB, -1), 0.0)
            tap = take_rows(rows, (blocks * ut + pos).reshape(-1)).reshape(
                NB, -1, Cc).float() * w[..., None]                      # [NB,8S,Cc]
            acc = tap if acc is None else acc + tap
        acc = acc.reshape(NB * BLOCK_RAYS, S, Cc)[:R]
        if scales is not None:
            acc = acc * scales[v]
        sampled.append(acc)
    return pair_cosine_mean(sampled, n_groups)


def block_cosine_prior(table, grids, scales, n_groups: int, ut: int):
    """The kernel on CUDA tensors (int8 tables [V,h,w,(V-1)128], V = 2 to
    8, with f32 scales and bf16 tables without: Kernel D; f32 tables without
    scales: D', with its backward when autograd records), the plain version
    on CPU tensors.
    The kernel builds each block's union itself: the wrapper launches
    nothing but the kernel."""
    if table.device.type == "cpu":
        return block_cosine_prior_plain(table, grids, scales, n_groups, ut)
    if not table.is_cuda:
        raise ValueError(f"block_cosine_prior: unsupported device {table.device}")
    if table.dtype == torch.float32 and scales is None:
        if torch.is_grad_enabled() and table.requires_grad:
            return BlockCosinePriorFn.apply(table, grids, n_groups, ut)
        return _forward(table, grids, None, n_groups, ut)[0]
    if (table.dtype == torch.bfloat16 and scales is None) or (
            table.dtype == torch.int8 and scales is not None):
        return _forward(table, grids, scales, n_groups, ut)[0]
    raise ValueError(f"block_cosine_prior: table dtype {table.dtype}, the kernel takes int8 "
                     "tables with scales or f32 and bf16 tables without")


def _forward(table, grids, scales, n_groups: int, ut: int, with_unions: bool = False):
    """Kernel D (int8, bf16 tables) or D''s forward (f32) -> (out [R,S,G],
    the union [V*ceil(R/8), ut] int32 the kernel built, or None)."""
    check_table("block_cosine_prior", table)
    V, H, W, Cc = table.shape
    R, S = grids.shape[1:3]
    if n_groups not in (1, 2, 4, 8, 16):
        raise ValueError(f"block_cosine_prior: n_groups={n_groups}, kernel takes 1, 2, "
                         "4, 8 or 16")
    if ut not in UT_BUCKETS:
        raise ValueError(f"block_cosine_prior: ut={ut}, kernel takes one of {UT_BUCKETS}")
    if (grids.dtype != torch.float32 or grids.dim() != 4 or grids.shape[0] != V
            or grids.shape[-1] != 2 or grids.device != table.device):
        raise ValueError(f"block_cosine_prior: grids {tuple(grids.shape)} {grids.dtype}, "
                         f"kernel takes f32 [{V},R,S,2] on {table.device}")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != (V, Cc)
                               or scales.device != table.device):
        raise ValueError(f"block_cosine_prior: the kernel takes f32 scales [{V},{Cc}]")
    for name, t in (("table", table), ("grids", grids), ("scales", scales)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"block_cosine_prior: {name} must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("block_cosine_prior: the table must be 16-byte aligned")
    itemsize = 4 if table.dtype == torch.float32 else 2      # int8 rows stage as bf16
    cp = channels_per_pass(ut, S, n_groups, False, itemsize, H * W, V)
    if cp is None:
        raise ValueError(f"block_cosine_prior: {table.dtype} tables of {V} views of {H}x{W} "
                         f"cells at ut={ut}, S={S}, G={n_groups} exceed the block's shared "
                         "memory")
    out = torch.empty(R, S, n_groups, dtype=torch.float32, device=table.device)
    NB = -(-R // BLOCK_RAYS)
    unions = (torch.empty(V * NB, ut, dtype=torch.int32, device=table.device)
              if with_unions else None)
    if R > 0:
        counter = F32_COUNTER if table.dtype == torch.float32 else COUNTER
        kernels.launch(counter, ENTRIES[table.dtype], table.data_ptr(), grids.data_ptr(),
                       kernels.ptr(scales), kernels.ptr(unions), out.data_ptr(), V, H, W,
                       Cc // (V - 1), n_groups, R, S, ut, cp)
    return out, unions


class BlockCosinePriorFn(torch.autograd.Function):
    """D' forward and backward on a CUDA f32 table; saves the table, the
    grids and the union the forward kernel built, and runs the backward's
    count pass after the forward."""

    @staticmethod
    def forward(ctx, table, grids, n_groups: int, ut: int):
        out, unions = _forward(table, grids, None, n_groups, ut, with_unions=True)
        ctx.save_for_backward(table, grids, unions)
        ctx.shape = (grids.shape[1], grids.shape[2], n_groups, ut)
        ctx.runs = count_runs(table, grids, unions, n_groups, ut) if grids.shape[1] else None
        return out

    @staticmethod
    def backward(ctx, g):
        table, grids, unions = ctx.saved_tensors
        _, _, G, ut = ctx.shape
        return (table_grad(table, grids, unions, g.contiguous(), G, ut, ctx.runs), None, None,
                None)


def count_runs(table, grids, unions, n_groups: int, ut: int) -> RecordCount:
    """D''s count pass over the (edge-padded) grids and the forward's
    unions; the walks are those of the backward's pass width."""
    V, H, W, _ = table.shape
    R, S = grids.shape[1:3]
    gp = pad_rays(grids)
    NB = gp.shape[1] // BLOCK_RAYS
    cp = channels_per_pass(ut, S, n_groups, backward=True, n_views=V)
    walks = BWD_THREADS // (8 if cp == 32 else 16)
    counts = torch.empty(NB * walks * V, dtype=torch.int32, device=table.device)
    kernels.call("block_cosine_prior_bwd_count", gp.data_ptr(), unions.data_ptr(),
                 counts.data_ptr(), V, H, W, R, S, NB, ut, cp)
    return RecordCount(counts)


def table_grad(table, grids, unions, g, n_groups: int, ut: int, runs: RecordCount = None):
    """D''s backward: d_table of the f32 prior for the cotangent g [R,S,G]
    over the forward's unions, the same bits on every run (the count pass,
    unless `runs` holds it, the records, their sum per cell in a fixed
    order: cosine_prior.table_grad_from_records)."""
    V, H, W, Cc = table.shape
    R, S = grids.shape[1:3]
    d_table = torch.zeros_like(table)
    if R == 0:
        return d_table
    gp = pad_rays(grids)
    NB = gp.shape[1] // BLOCK_RAYS
    cp = channels_per_pass(ut, S, n_groups, backward=True, n_views=V)
    runs = runs or count_runs(table, grids, unions, n_groups, ut)
    n = runs.n()
    rec = torch.empty(n, Cc, dtype=torch.float32, device=table.device)
    keys = torch.empty(n, dtype=torch.int32, device=table.device)
    kernels.launch(BWD_COUNTER, "block_cosine_prior_bwd_f32", table.data_ptr(), gp.data_ptr(),
                   unions.data_ptr(), g.data_ptr(), runs.starts.data_ptr(), rec.data_ptr(),
                   keys.data_ptr(), V, H, W, Cc // (V - 1), n_groups, R, S, NB, ut, cp)
    table_grad_from_records(keys, rec, d_table)
    return d_table
