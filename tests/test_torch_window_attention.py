"""Kernel A (window attention) of the PyTorch port vs the JAX package.

The port's `split_window_attention` (roll + split in torch, then the plain
window attention on the CPU) is held against the JAX XLA path
`split_window_attention` and the Pallas flash kernel
`flash_window_attention(interpret=True)`, with and without the shift.
Windows have L = 8 x 16 = 128 tokens and C = 128, so the flash kernel
engages instead of its L < 128 XLA fallback. Tolerance atol 2e-5, as
tests/test_pallas_attention.py uses for the flash kernel (online-softmax
reassociation). The CUDA kernel itself is compared with the plain version
on the card by chip_smoke.py. The error model of the kernels' f32 route
(split TF32 on tensor cores) is emulated on the CPU at the end.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchnerf_tpu.ops import attention as jattn
from matchnerf_tpu.ops.pallas_attention import flash_window_attention
from matchnerf_tpu_torch.ops import attention as tattn
from matchnerf_tpu_torch.ops import window_attention as twa
from torch_threads import one_torch_thread  # noqa: F401

B, H, W, C, SPLITS = 2, 16, 32, 128, 2


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("with_shift", [False, True])
def test_plain_window_attention_matches_jax(with_shift):
    q, k, v = _inputs(0)
    mask = jattn.generate_shift_window_attn_mask(H, W, H // 2, W // 2, H // 4, W // 4)
    ref_xla = jattn.split_window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           num_splits=SPLITS, with_shift=with_shift,
                                           attn_mask=mask)
    ref_flash = flash_window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       num_splits=SPLITS, with_shift=with_shift,
                                       attn_mask=mask, interpret=True)
    rid = tattn.shift_region_ids(H, W, SPLITS)
    before = twa.COUNTER.launches
    got = tattn.split_window_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                       SPLITS, with_shift, region_ids=rid)
    assert twa.COUNTER.launches == before       # CPU tensors take the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_xla), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_flash), atol=2e-5)


def test_window_attention_plain_masks_across_regions():
    """A key in another region gets -100 after scaling: with a huge key
    only in a foreign region, the output must ignore it."""
    L = 8
    rid = torch.tensor([[0, 0, 0, 0, 1, 1, 1, 1]], dtype=torch.int32)
    q = torch.zeros(1, L, 128)
    k = torch.zeros(1, L, 128)
    v = torch.arange(L, dtype=torch.float32)[None, :, None].expand(1, L, 128).contiguous()
    out = twa.window_attention(q, k, v, rid)
    torch.testing.assert_close(out[0, :4, 0], torch.full((4,), 1.5), atol=1e-6, rtol=0)
    torch.testing.assert_close(out[0, 4:, 0], torch.full((4,), 5.5), atol=1e-6, rtol=0)


def test_window_attention_rejects_unsupported_devices():
    q = torch.zeros(1, 4, 128, device="meta")
    with pytest.raises(ValueError):
        twa.window_attention(q, q, q)


# ---- the error model of Kernel A / A''s f32 route (split TF32), on the CPU
#
# The f32 kernels run every product on TF32 tensor cores. A tensor core
# reads 19 bits of each f32 operand (it drops the low 13). The kernels split
# each operand x into hi = x rounded to nearest at 19 bits (ties away) and
# lo = x - hi, which the tensor core truncates, and take hi*hi + hi*lo +
# lo*hi for each f32 product. Here the same products are emulated in torch
# (sums in float64, so the tensor core's accumulation is not modelled),
# through the forward and, by autograd, the backward, and held to the GPU
# tests' f32 tolerances (1e-5 on the output, 1e-4 of the largest gradient)
# against float64 attention on the same inputs. A single TF32 product per
# f32 product misses the forward tolerance: the kernels need all three.

def _tf32_rna(x):
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _tf32_trunc(x):
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _tc_matmul(a, b, split):
    """a @ b with f32 operands as the tensor cores read them, in float64."""
    a, b = a.float(), b.float()
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    out = ah.double() @ bh.double()
    if split:
        al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
        out = out + ah.double() @ bl.double() + al.double() @ bh.double()
    return out


class _TcMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, split):
        ctx.save_for_backward(a, b)
        ctx.split = split
        return _tc_matmul(a, b, split)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return (_tc_matmul(g, b.transpose(-1, -2), ctx.split),
                _tc_matmul(a.transpose(-1, -2), g, ctx.split), None)


def _attention_f64(q, k, v, bias, mm):
    """float64 attention with the -100 bias after scaling; mm(a, b) is the
    matrix product."""
    s = mm(q, k.transpose(-1, -2)) / np.sqrt(q.shape[-1]) + bias
    return mm(torch.softmax(s, dim=-1), v)


def _emulated_errors(shape, hw, split):
    """Max |d| of the output and the largest gradient error over the largest
    gradient, emulated products against float64, shift-masked."""
    bw, L, c = shape
    rng = np.random.default_rng(L)
    q, k, v, do = (torch.tensor(rng.standard_normal(shape).astype(np.float32))
                   for _ in range(4))
    rid = tattn.shift_region_ids(*hw, 2)
    rows = rid[torch.arange(bw) % rid.shape[0]]
    bias = torch.where(rows[:, :, None] != rows[:, None, :], -100.0, 0.0).double()
    results = []
    for mm in (torch.matmul, lambda a, b: _TcMatmul.apply(a, b, split)):
        leaves = [t.double().requires_grad_() for t in (q, k, v)]
        out = _attention_f64(*leaves, bias, mm)
        results.append((out.detach(), torch.autograd.grad(out, leaves, do.double())))
    (ref, ref_grads), (got, grads) = results
    gmax = max(float(g.abs().max()) for g in ref_grads)
    return (float((got - ref).abs().max()),
            max(float((a - b).abs().max()) for a, b in zip(grads, ref_grads)) / gmax)


@pytest.mark.parametrize("shape,hw", [((8, 160, 128), (16, 40)), ((2, 1280, 128), (64, 80))])
def test_split_tf32_holds_the_f32_tolerances(shape, hw):
    out_err, grad_err = _emulated_errors(shape, hw, split=True)
    assert out_err <= 1e-5, out_err
    assert grad_err <= 1e-4, grad_err


@pytest.mark.parametrize("shape,hw", [((8, 160, 128), (16, 40)), ((2, 1280, 128), (64, 80))])
def test_one_tf32_product_misses_the_f32_tolerance(shape, hw):
    out_err, _ = _emulated_errors(shape, hw, split=False)
    assert out_err > 1e-5, out_err
