"""Kernels B and B': the grouped-cosine matching prior of one feature scale.

Replaces matchnerf_tpu/ops/pallas_banded.py::banded_cosine_scale (the
per-ray banded Pallas kernel of the eval path) and
::banded_cosine_scale_trainable (its custom VJP on f32 training tables).
The CUDA source is csrc/cosine_prior.cu; `cosine_prior_plain` is the same
function in plain PyTorch (the JAX direct path: `grid_sample` on each view,
then `_grouped_cosine`, matchnerf.py:389-402), and its autograd is the
plain backward. On a CUDA f32 table that requires grad, `cosine_prior`
goes through `CosinePriorFn`: Kernel B forward, then the B' backward
kernel, which walks each ray's consecutive samples in order and sums a
tap cell's gradient over each run of samples that keep the cell (the JAX
VJP's per-ray dedup, done in the kernel); each run is a record at a
position fixed by the input, and the records of a cell are summed in that
order (`table_grad_from_records`), so two runs give the same bits, as the
JAX step does. The sample grids get no gradient (the JAX VJP returns zeros
for them). On bf16 tables (the
eval renders of configs/train.yaml) the JAX package reaches the
`_trainable` wrapper too, whose forward is the same kernel: here Kernel B's
bf16 forward.

For every sample and every view it bilinearly samples the view's unpacked
table [V,h,w,(V-1)*C] (align_corners, border clamp), multiplies by the
per-(view, channel) dequantisation scale after interpolation, then for each
pair (i, j) of `pair_index_lists` takes the grouped cosine of view i's chunk
j-1 against view j's chunk i (eps 1e-8 on each norm) and averages over the
pairs. Output [R,S,G] f32. The JAX package's `kt` buckets and 2x2
packing only existed to save TPU gathers and are not carried.
"""
from __future__ import annotations

import torch

from .. import kernels
from .grid_sample import grid_sample_2d

SOURCE = "matchnerf_tpu_torch/csrc/cosine_prior.cu"
# the view counts (n_src_views) the kernels take (csrc/views.cuh), and the
# channels of one pair chunk: a view's table row holds V-1 chunks
VIEWS = tuple(range(2, 9))
CHUNK = 128
COUNTER = kernels.LaunchCounter(
    "cosine_prior", source=SOURCE, replaces="matchnerf_tpu/ops/pallas_banded.py:267")
BWD_COUNTER = kernels.LaunchCounter(
    "cosine_prior_bwd", source=SOURCE, replaces="matchnerf_tpu/ops/pallas_banded.py:484")
# the forward's C launcher per table dtype; bf16 tables (the eval renders of
# configs/train.yaml) come without scales, as the TPU kernel takes them
ENTRIES = {torch.int8: "cosine_prior_i8", torch.bfloat16: "cosine_prior_bf16",
           torch.float32: "cosine_prior_f32"}
WALK = 64                         # B''s consecutive samples per walk (csrc WALK)


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


def pair_cosine_mean(sampled, n_groups: int):
    """Per-view sampled features [V x [...,(V-1)C]] -> [...,G]: for each pair
    (i, j), view i's chunk j-1 against view j's chunk i, averaged."""
    V = len(sampled)
    C = sampled[0].shape[-1] // (V - 1)
    pairs = pair_index_lists(V)
    total = None
    for (i, j) in pairs:
        ca, cb = j - 1, i
        cos = grouped_cosine(sampled[i][..., ca * C:(ca + 1) * C],
                             sampled[j][..., cb * C:(cb + 1) * C], n_groups)
        total = cos if total is None else total + cos
    return total / len(pairs)


def cosine_prior_plain(table, grids, scales, n_groups: int):
    """table [V,h,w,(V-1)C] (int8/f32/bf16); grids [V,R,S,2] f32; scales
    [V,(V-1)C] f32 or None -> [R,S,G] f32."""
    if table.is_cuda:
        COUNTER.plain_on_cuda += 1
    sampled = []
    for v in range(table.shape[0]):
        s = grid_sample_2d(table[v:v + 1], grids[v:v + 1])[0]       # [R,S,(V-1)C]
        if scales is not None:
            s = s * scales[v]
        sampled.append(s)
    return pair_cosine_mean(sampled, n_groups)


def check_table(name: str, table) -> None:
    """Raise unless `table` is [V,h,w,(V-1)*128] with V in VIEWS, the
    tables the prior kernels B, B', D and D' take."""
    V = table.shape[0] if table.dim() == 4 else None
    if V not in VIEWS or table.shape[-1] != (V - 1) * CHUNK:
        raise ValueError(f"{name}: table {tuple(table.shape)} (V={V} views), the kernel takes "
                         f"V = {VIEWS[0]} to {VIEWS[-1]} views of [V,h,w,(V-1)*{CHUNK}]")


def cosine_prior(table, grids, scales, n_groups: int):
    """The kernel on CUDA tensors (V = 2 to 8 views, C = 128, int8, bf16 or
    f32 tables; with the B' backward when autograd records through an f32
    table), the plain version on CPU tensors."""
    if table.device.type == "cpu":
        return cosine_prior_plain(table, grids, scales, n_groups)
    if not table.is_cuda:
        raise ValueError(f"cosine_prior: unsupported device {table.device}")
    if torch.is_grad_enabled() and table.requires_grad:
        if scales is not None or table.dtype != torch.float32:
            raise ValueError("cosine_prior: the backward takes f32 tables without "
                             "dequantisation scales")
        return CosinePriorFn.apply(table, grids, n_groups)
    return _forward(table, grids, scales, n_groups)


def _forward(table, grids, scales, n_groups: int):
    if table.dtype not in ENTRIES:
        raise ValueError(f"cosine_prior: table dtype {table.dtype} (int8, bf16 or f32)")
    check_table("cosine_prior", table)
    V, H, W, Cc = table.shape
    C = Cc // (V - 1)
    if n_groups not in (1, 2, 4, 8, 16):
        raise ValueError(f"cosine_prior: n_groups={n_groups}, kernel takes 1, 2, 4, 8 or 16")
    if (grids.dtype != torch.float32 or grids.dim() != 4 or grids.shape[0] != V
            or grids.shape[-1] != 2 or grids.device != table.device):
        raise ValueError(f"cosine_prior: grids {tuple(grids.shape)} {grids.dtype}, "
                         f"kernel takes f32 [{V},R,S,2] on {table.device}")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != (V, Cc)
                               or scales.device != table.device):
        raise ValueError(f"cosine_prior: scales {tuple(scales.shape)} {scales.dtype}, "
                         f"kernel takes f32 [{V},{Cc}]")
    for name, t in (("table", table), ("grids", grids), ("scales", scales)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"cosine_prior: {name} is not contiguous")
    R, S = grids.shape[1:3]
    out = torch.empty(R, S, n_groups, dtype=torch.float32, device=table.device)
    kernels.launch(COUNTER, ENTRIES[table.dtype], table.data_ptr(), grids.data_ptr(),
                   kernels.ptr(scales), out.data_ptr(), V, H, W, C, n_groups, R * S)
    return out


class RecordCount:
    """The runs of B' or D''s backward from its count pass (`counts`, per
    unit): each unit's first record (the exclusive scan, int32 on the
    device) and the number of records, copied to pinned host memory behind
    an event. The wrappers count in the forward, so the backward's read of
    the number (it sizes the records' buffer) finds it long copied and
    does not wait for the device."""

    def __init__(self, counts):
        ends = torch.cumsum(counts, 0, dtype=torch.int32)
        self.starts = ends - counts
        self.total = torch.zeros((), dtype=torch.int32, pin_memory=True)
        if ends.numel():
            self.total.copy_(ends[-1], non_blocking=True)
        self.ready = torch.cuda.Event()
        self.ready.record()

    def n(self) -> int:
        self.ready.synchronize()
        return int(self.total)


def table_grad_from_records(keys, rec, d_table) -> None:
    """B' and D''s last pass: sort the records' table rows `keys` [n]
    int32, stably, and sum each row's records rec [n, (V-1)C] f32 in that
    order (their positions) into d_table (zeroed by the caller)."""
    n, CC = rec.shape
    if n == 0:
        return
    sorted_keys, order = torch.sort(keys, stable=True)
    kernels.call("prior_bwd_reduce_f32", sorted_keys.data_ptr(), order.data_ptr(),
                 rec.data_ptr(), d_table.data_ptr(), n, CC)


def count_runs(table, grids) -> RecordCount:
    """B''s count pass over the grids [V,R,S,2] of a table [V,h,w,(V-1)C]."""
    V, H, W, _ = table.shape
    N = grids.shape[1] * grids.shape[2]
    counts = torch.empty(-(-N // WALK) * V, dtype=torch.int32, device=table.device)
    if N:
        kernels.call("cosine_prior_bwd_count", grids.data_ptr(), counts.data_ptr(), V, H, W,
                     N)
    return RecordCount(counts)


def table_grad(table, grids, g, n_groups: int, runs: RecordCount = None):
    """The B' backward: d_table of the f32 prior [V,h,w,(V-1)C] for the
    cotangent g [R,S,G], the same bits on every run (the count pass, unless
    `runs` holds it, the records, their sum per cell in a fixed order)."""
    V, H, W, Cc = table.shape
    R, S = grids.shape[1:3]
    N = R * S
    d_table = torch.zeros_like(table)
    if N == 0:
        return d_table
    runs = runs or count_runs(table, grids)
    n = runs.n()
    rec = torch.empty(n, Cc, dtype=torch.float32, device=table.device)
    keys = torch.empty(n, dtype=torch.int32, device=table.device)
    kernels.launch(BWD_COUNTER, "cosine_prior_bwd_f32", table.data_ptr(), grids.data_ptr(),
                   g.data_ptr(), runs.starts.data_ptr(), rec.data_ptr(), keys.data_ptr(), V,
                   H, W, Cc // (V - 1), n_groups, N)
    table_grad_from_records(keys, rec, d_table)
    return d_table


class CosinePriorFn(torch.autograd.Function):
    """Kernel B forward and the B' backward on a CUDA f32 table; saves the
    table and the grids, and runs the backward's count pass after the
    forward."""

    @staticmethod
    def forward(ctx, table, grids, n_groups: int):
        ctx.save_for_backward(table, grids)
        ctx.n_groups = n_groups
        out = _forward(table, grids, None, n_groups)
        ctx.runs = count_runs(table, grids)
        return out

    @staticmethod
    def backward(ctx, g):
        table, grids = ctx.saved_tensors
        return (table_grad(table, grids, g.contiguous(), ctx.n_groups, ctx.runs), None,
                None)
