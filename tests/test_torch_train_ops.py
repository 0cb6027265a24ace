"""The training kernels' plain versions (A', B', D') against the JAX
package's custom-VJP Pallas kernels, on the CPU (interpret mode).

Each case makes its inputs and a cotangent from a seeded numpy generator,
differentiates the JAX kernel with `jax.vjp` and the port's plain version
(the function each CUDA kernel is held to on the card) with autograd.

- A' window attention (`split_window_attention`, the plain core on CPU
  tensors) vs `fused_window_attention(interpret=True)`: a 32 x 32 map in
  2 x 2 windows gives L = 256, a multiple of 128, so JAX takes its Pallas
  kernel and not its XLA fallback. f32: neither side rounds; atol 1e-5 of
  the largest gradient (reassociation only). bf16: JAX rounds the
  attention A and dS to bf16 before its matmuls
  (pallas_window_attention.py:79,99); the port's plain version rounds A to
  bf16 before A.V, and its autograd rounds dA (the bf16 dO.V^T product) and
  the gradients of the bf16 inputs; with both rounding at ~2^-8 relative,
  the tolerance is 3e-2 of the largest gradient.
- B' per-ray cosine prior: the table gradient of `cosine_prior_plain` vs
  `banded_cosine_scale_trainable` on the 2x2-packed table, JAX's packed
  gradient folded onto the unpacked table as
  tests/test_pallas_block_banded.py folds it. One group is all zero, so its
  norms clamp at eps and the gate passes no gradient through them. The
  tolerance of the JAX package's own test: atol 1e-4, rtol 1e-3.
- D' block cosine prior: forward values (atol 2e-5) and the table gradient
  of `block_cosine_prior_plain` (f32, no scales) vs
  `block_banded_cosine_scale_trainable`, on full and ragged ray counts. The
  JAX backward returns a padded grid cotangent for a ragged R, which its
  custom VJP refuses; so the ragged case hands JAX the edge-padded grids
  and a zero cotangent on the padding rays, which adds nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchnerf_tpu.models.gmflow.gmflow import pair_index_lists
from matchnerf_tpu.ops import pallas_block_banded as jbb
from matchnerf_tpu.ops.attention import generate_shift_window_attn_mask
from matchnerf_tpu.ops.grid_sample import pack_2x2
from matchnerf_tpu.ops.pallas_banded import banded_cosine_scale_trainable
from matchnerf_tpu.ops.pallas_window_attention import fused_window_attention
from matchnerf_tpu_torch.ops import attention as tattn
from matchnerf_tpu_torch.ops import block_cosine_prior as kd
from matchnerf_tpu_torch.ops import cosine_prior as kb
from torch_threads import one_torch_thread  # noqa: F401

V = 3
PAIRS = tuple(pair_index_lists(V))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_shift", [False, True])
def test_window_attention_grads_match_jax(with_shift, dtype):
    rng = np.random.default_rng(0)
    B, H, W, C, K = 1, 32, 32, 128, 2
    q, k, v, do = (rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(4))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    mask = generate_shift_window_attn_mask(H, W, H // K, W // K, H // 2 // K, W // 2 // K)

    def jfn(q, k, v):
        return fused_window_attention(q, k, v, K, with_shift, attn_mask=mask,
                                      interpret=True)

    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    jout, vjp = jax.vjp(jfn, jq, jk, jv)
    jgrads = vjp(jnp.asarray(do).astype(jd))

    tq, tk, tv = (torch.tensor(x).to(td).requires_grad_() for x in (q, k, v))
    rid = tattn.shift_region_ids(H, W, K)
    out = tattn.split_window_attention(tq, tk, tv, K, with_shift, region_ids=rid)
    out.backward(torch.tensor(do).to(td))
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    ref_out = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(out.detach().float().numpy(), ref_out,
                               atol=tol * np.abs(ref_out).max())
    for name, t, jg in zip("qkv", (tq, tk, tv), jgrads):
        ref = np.asarray(jg.astype(jnp.float32))
        np.testing.assert_allclose(t.grad.float().numpy(), ref,
                                   atol=tol * np.abs(ref).max(), err_msg=f"d{name}")


def _coherent_grids(rng, R, S, spread=0.5):
    """[V,R,S,2] straight segments; rays of an 8-ray block start close
    together, as the pixels of one strip do."""
    starts = rng.uniform(-0.9, 0.3, (V, (R + 7) // 8, 1, 2)) \
        + rng.normal(0, 0.01, (V, (R + 7) // 8, 8, 2))
    starts = starts.reshape(V, -1, 2)[:, :R]
    ends = starts + rng.uniform(0.05, spread, (V, R, 2))
    t = np.linspace(0, 1, S)[None, None, :, None]
    return (starts[:, :, None] * (1 - t) + ends[:, :, None] * t).astype(np.float32)


def _fold_packed_grad(gp, Cc):
    """Transpose of pack_2x2 (shift + concat): four shifted adds of the
    packed gradient [V,H,W,4Cc] onto the unpacked table."""
    acc = np.zeros(gp.shape[:3] + (Cc,), np.float32)
    acc += gp[..., :Cc]
    acc[:, :, 1:] += gp[:, :, :-1, Cc:2 * Cc]
    acc[:, :, -1] += gp[:, :, -1, Cc:2 * Cc]
    acc[:, 1:] += gp[:, :-1, :, 2 * Cc:3 * Cc]
    acc[:, -1] += gp[:, -1, :, 2 * Cc:3 * Cc]
    acc[:, 1:, 1:] += gp[:, :-1, :-1, 3 * Cc:]
    acc[:, 1:, -1] += gp[:, :-1, -1, 3 * Cc:]
    acc[:, -1, 1:] += gp[:, -1, :-1, 3 * Cc:]
    acc[:, -1, -1] += gp[:, -1, -1, 3 * Cc:]
    return acc


def _port_grad(fn, feat, grids, gcot):
    table = torch.tensor(feat, requires_grad=True)
    out = fn(table, torch.tensor(grids))
    out.backward(torch.tensor(gcot))
    return out.detach().numpy(), table.grad.numpy()


def test_cosine_prior_table_grad_matches_jax():
    rng = np.random.default_rng(4)
    H, W, C, R, S, G = 20, 24, 16, 12, 24, 4
    Cc = (V - 1) * C
    feat = rng.normal(0, 1, (V, H, W, Cc)).astype(np.float32)
    feat[..., :C // G] = 0.0            # group 0 of chunk 0: the eps gate
    grids = _coherent_grids(rng, R, S)
    grids[:, :2, :3] = np.clip(grids[:, :2, :3] * 3.0, -1.0, 1.0)    # border taps
    gcot = rng.normal(0, 1, (R, S, G)).astype(np.float32)

    packed = jax.vmap(lambda f: pack_2x2(f[None])[0])(jnp.asarray(feat))[None]
    jgrids = jnp.asarray(grids)[:, None]
    jout, vjp = jax.vjp(lambda vf: banded_cosine_scale_trainable(vf, jgrids, 48, G,
                                                                 PAIRS, 8), packed)
    (jg,) = vjp(jnp.asarray(gcot)[None])
    out, grad = _port_grad(lambda t, g: kb.cosine_prior_plain(t, g, None, G),
                           feat, grids, gcot)
    np.testing.assert_allclose(out, np.asarray(jout)[0], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(grad, _fold_packed_grad(np.asarray(jg)[0], Cc),
                               atol=1e-4, rtol=1e-3)
    # the gated group still gets its d(dot) gradient, only the norm path is cut
    assert np.abs(grad[..., :C // G]).max() > 0


@pytest.mark.parametrize("R", [16, 13])
def test_block_cosine_prior_table_grad_matches_jax(R):
    rng = np.random.default_rng(11)
    H, W, C, S, G = 24, 28, 16, 24, 4
    Cc = (V - 1) * C
    feat = rng.normal(0, 1, (V, H, W, Cc)).astype(np.float32)
    grids = _coherent_grids(rng, R, S, spread=0.3)
    gcot = rng.normal(0, 1, (R, S, G)).astype(np.float32)
    pad = (-R) % 8
    gp = np.concatenate([grids, np.repeat(grids[:, -1:], pad, axis=1)], axis=1)
    ut = kd.bucket_ut(kd.block_union_size_raw(torch.tensor(gp), H, W))
    want_ut = max(jbb.bucket_ut(int(jbb.block_union_size_raw(jnp.asarray(gp[v]), H, W)))
                  for v in range(V))
    assert ut == want_ut

    jgrids = jnp.asarray(gp)[:, None]
    jout, vjp = jax.vjp(lambda vf: jbb.block_banded_cosine_scale_trainable(
        vf, jgrids, 48, ut, G, PAIRS, 8), jnp.asarray(feat)[None])
    (jg,) = vjp(jnp.asarray(np.pad(gcot, ((0, pad), (0, 0), (0, 0))))[None])
    out, grad = _port_grad(lambda t, g: kd.block_cosine_prior_plain(t, g, None, G, ut),
                           feat, grids, gcot)
    np.testing.assert_allclose(out, np.asarray(jout)[0, :R], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(grad, np.asarray(jg)[0], atol=1e-4, rtol=1e-3)
    # the block route and the per-ray route are the same function
    _, grad_b = _port_grad(lambda t, g: kb.cosine_prior_plain(t, g, None, G),
                           feat, grids, gcot)
    np.testing.assert_allclose(grad, grad_b, atol=1e-5, rtol=1e-5)


def test_f32_block_staging_fits_the_training_buckets():
    """D' takes the buckets of the DTU training pose (160 rows at G=2, 320 at
    G=8, S=128) and declines what no staging pass width fits."""
    assert kd.channels_per_pass(160, 128, 2, backward=False) == 128
    assert kd.channels_per_pass(160, 128, 2, backward=True) == 64
    assert kd.channels_per_pass(320, 128, 8, backward=False) == 64
    assert kd.channels_per_pass(320, 128, 8, backward=True) == 32
    assert kd.takes_f32(160, 128, 2) and kd.takes_f32(320, 128, 8)
    assert not kd.takes_f32(320, 128, 2) and not kd.takes_f32(512, 128, 8)


@pytest.mark.parametrize("failure", ["launch", "build"])
@pytest.mark.parametrize("kernel", ["B'", "D'"])
def test_prior_backward_raises_without_fallback(monkeypatch, kernel, failure):
    """On the card a failed launch (the C entry returns a CUDA error) or a
    failed build of B' or D''s backward raises out of the autograd
    Function's backward: neither falls back to its plain twin. Driven here
    with a stand-in library on CPU tensors."""
    from matchnerf_tpu_torch import kernels

    class FailingLib:
        def __getattr__(self, name):
            return lambda *args: 700          # cudaErrorIllegalAddress

    def no_build():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(kernels, "library", (lambda: FailingLib()) if failure == "launch"
                        else no_build)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("Stream", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "stand-in")
    table = torch.zeros(3, 8, 8, 256)
    grids = torch.zeros(3, 8, 4, 2)
    ctx = type("Ctx", (), {})()
    ctx.runs = None                       # no forward ran: the backward counts itself
    if kernel == "B'":
        ctx.saved_tensors, ctx.n_groups = (table, grids), 2
        fn, counter = kb.CosinePriorFn, kb.BWD_COUNTER
    else:
        ctx.saved_tensors = (table, grids, torch.zeros(3, 64, dtype=torch.int32))
        ctx.shape = (8, 4, 2, 64)
        fn, counter = kd.BlockCosinePriorFn, kd.BWD_COUNTER
    before = (counter.launches, kb.COUNTER.plain_on_cuda, kd.COUNTER.plain_on_cuda)
    with pytest.raises(RuntimeError, match="CUDA error 700" if failure == "launch"
                       else "nvcc failed"):
        fn.backward(ctx, torch.zeros(8, 4, 2))
    assert (counter.launches, kb.COUNTER.plain_on_cuda, kd.COUNTER.plain_on_cuda) == before
