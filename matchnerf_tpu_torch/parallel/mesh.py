"""What the device mesh did, for ranks of one card each (counterpart of
matchnerf_tpu/parallel/mesh.py).

The JAX package shards an array's batch, ray or stream axis over a
`('data',)` mesh and XLA gathers and reduces. Here each rank holds its
contiguous chunk of such an axis and these functions move the rest:

- `chunk(n, rank, size)`: the rank's rows of an axis of n rows that the
  ranks split evenly (batch and ray axes: n % size == 0 is the caller's
  check); `stream_rows(n, ...)`: the rank's rows of an axis they may split
  unevenly (encoder streams): ceil(n / size) each, the last rank's chunk
  padded with copies of row n - 1 (a rank past the end holds only
  padding), as GSPMD pads an uneven shard.
- `gather_rows(local, n)`: every rank gets all n rows from every rank's
  `local` (ceil(n / size) rows each, rank order; padding dropped), with a
  gradient: backward, each rank's cotangent of the full tensor is summed
  over the ranks and the rank keeps the rows it gave (padding rows get
  zeros).
- `average_gradients(params)`: one all-reduce of every parameter's
  gradient, averaged over the ranks (the JAX step's gradient psum); a
  parameter without a gradient takes part with zeros.

Gathers are all-reduces of zero-padded buffers (each rank writes its rows
into a zeroed full-size buffer; the sum over ranks is the gather): gloo
offers only broadcast and all-reduce on CUDA tensors. The forward sums
f32 values' bit patterns as integers, so the gather is bit-exact.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch

from . import distributed as dist

_INT_OF_SIZE = {4: torch.int32, 8: torch.int64}     # neither backend sums int16


def rank_and_size() -> Tuple[int, int]:
    return dist.process_index(), dist.process_count()


def chunk(n: int) -> slice:
    """The rank's contiguous rows of an axis of n rows split evenly."""
    rank, size = rank_and_size()
    if n % size:
        raise ValueError(f"{n} rows do not split evenly over {size} ranks")
    k = n // size
    return slice(rank * k, (rank + 1) * k)


def stream_rows(n: int, device=None) -> torch.Tensor:
    """The rank's ceil(n / size) row indices of an axis of n rows, padded
    with n - 1."""
    rank, size = rank_and_size()
    k = -(-n // size)
    return torch.clamp_max(torch.arange(rank * k, (rank + 1) * k, device=device), n - 1)


def _sum_bits(buf: torch.Tensor) -> torch.Tensor:
    """All-reduce `buf` (zeros outside this rank's rows): 4- and 8-byte
    floats as integers of their size, so the sum is exactly the gather;
    2-byte floats as themselves (x + 0 is x, a negative zero aside)."""
    bits = (buf.view(_INT_OF_SIZE[buf.element_size()])
            if buf.is_floating_point() and buf.element_size() in _INT_OF_SIZE else buf)
    torch.distributed.all_reduce(bits)
    return buf


def _gather(local: torch.Tensor, n: int) -> torch.Tensor:
    rank, size = rank_and_size()
    k = local.shape[0]
    buf = local.new_zeros((k * size, *local.shape[1:]))
    buf[rank * k:(rank + 1) * k] = local
    return _sum_bits(buf)[:n]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, n):
        ctx.k = local.shape[0]
        return _gather(local.contiguous(), n)

    @staticmethod
    def backward(ctx, grad):
        rank, size = rank_and_size()
        k = ctx.k
        full = grad.new_zeros((k * size, *grad.shape[1:]), dtype=torch.float32)
        full[:grad.shape[0]] = grad
        torch.distributed.all_reduce(full)
        return full[rank * k:(rank + 1) * k].to(grad.dtype), None


def gather_rows(local: torch.Tensor, n: int) -> torch.Tensor:
    """[k, ...] rows of every rank -> [n, ...] on every rank; backward sums
    the full tensor's cotangent over the ranks (in f32) and keeps this
    rank's rows."""
    if dist.process_count() == 1:
        return local[:n]
    return _GatherRows.apply(local, n)


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of `t` (in place): ReduceOp.AVG where the
    backend has it (NCCL), else a sum and a division."""
    if dist.backend() == "nccl":
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.AVG)
    else:
        torch.distributed.all_reduce(t)
        t.div_(dist.process_count())
    return t


@torch.no_grad()
def average_gradients(params: Iterable[torch.nn.Parameter]):
    """Average every parameter's gradient over the ranks in one coalesced
    all-reduce per dtype; a missing gradient joins as zeros (and is then
    set), so no rank waits on a tensor another rank lacks."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype = {}
    for p in params:
        by_dtype.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_mean(flat)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
