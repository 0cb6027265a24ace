"""Kernel D (block-union cosine prior) of the PyTorch port vs the JAX
package, on the CPU.

- The union helpers (`base_cells`, `block_union_cells`,
  `block_union_size_raw`, `bucket_ut`) give the JAX integers exactly, on
  coherent grids and on a ragged R with samples pushed onto the border.
- The plain Kernel D vs JAX `block_banded_cosine_scale` (Pallas, interpret
  mode): atol 1e-2 on int8 tables, the bound tests/test_pallas_block_banded.py
  sets for that kernel's bf16 stencil weights; atol 2e-5 on f32 tables (f32
  one-hot matmul vs direct f32 interpolation, summation order only).
- The plain Kernel D vs the port's plain Kernel B on the same int8 tables:
  atol 1e-5, the same taps and f32 weights reached by another route.
- On bf16 tables (configs/train.yaml's eval renders, which the JAX package
  sends through `block_banded_cosine_scale_trainable`, whose forward is
  `block_banded_cosine_scale`): the JAX kernel at atol 1e-2 (its bf16
  stencil), the port's plain Kernel B at atol 1e-5; the bf16 staging fits
  every bucket at S = 128 and the route (`takes_table`) follows the dtype.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchnerf_tpu.models.gmflow.gmflow import pair_index_lists
from matchnerf_tpu.ops import pallas_block_banded as jbb
from matchnerf_tpu_torch.ops import block_cosine_prior as kd
from matchnerf_tpu_torch.ops import cosine_prior as kb

V = 3


def _coherent_grids(rng, R, S, spread=0.6):
    """Monotone straight segments per ray (epipolar-like) [V,R,S,2]; rays of
    one 8-ray block start close together, as adjacent pixels do."""
    starts = rng.uniform(-1.1, 0.3, (V, (R + 7) // 8, 1, 2)) \
        + rng.normal(0, 0.01, (V, (R + 7) // 8, 8, 2))
    starts = starts.reshape(V, -1, 2)[:, :R]
    ends = starts + rng.uniform(0.05, spread, (V, R, 2))
    t = np.linspace(0, 1, S)[None, None, :, None]
    return (starts[:, :, None, :] * (1 - t) + ends[:, :, None, :] * t).astype(np.float32)


def _border_grids(rng, R, S):
    """Ragged R with the first samples of every ray pushed past the border."""
    g = _coherent_grids(rng, R, S)
    g[:, :, :3] = np.clip(g[:, :, :3] * 3.0, -1.0, 1.0)
    g[:, -1, -2:] = 1.0                               # the (H-1, W-1) corner
    return g


def _int8_table(rng, H, W, C):
    feat = rng.normal(0, 1, (V, H, W, 2 * C)).astype(np.float32)
    scale = np.maximum(np.abs(feat).max(axis=(1, 2)), 1e-12) / 127.0     # [V,Cc]
    q = np.clip(np.round(feat / scale[:, None, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _pad_np(grids):
    pad = (-grids.shape[1]) % 8
    return np.concatenate([grids, np.repeat(grids[:, -1:], pad, axis=1)], axis=1)


def _ut(grids, H, W):
    return kd.bucket_ut(kd.block_union_size_raw(torch.tensor(_pad_np(grids)), H, W))


@pytest.mark.parametrize("case", ["coherent", "ragged_border"])
def test_union_helpers_match_jax(case):
    rng = np.random.default_rng(10)
    H, W, R, S = (24, 32, 24, 32) if case == "coherent" else (16, 16, 11, 16)
    grids = _coherent_grids(rng, R, S) if case == "coherent" else _border_grids(rng, R, S)
    gp = _pad_np(grids)

    cells = kd.base_cells(torch.tensor(gp), H, W).reshape(-1, S)
    jcells = jbb._cells_weights4(jnp.asarray(gp), H, W)[0].reshape(-1, S)
    assert cells.dtype == torch.int32
    np.testing.assert_array_equal(cells.numpy(), np.asarray(jcells))

    n = kd.block_union_size_raw(torch.tensor(gp), H, W)
    assert n == int(jbb.block_union_size_raw(jnp.asarray(gp), H, W))
    ut = kd.bucket_ut(n)
    assert ut == jbb.bucket_ut(n) and ut is not None

    for cap in (ut, 64):                      # 64 truncates the wider unions
        got = kd.block_union_cells(cells, 8, cap, H, W)
        want = jbb.block_union_cells(jcells, 8, cap, H, W)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got >= 0).sum(-1).max()) == min(n, 64)


def test_bucket_ut_matches_jax():
    for n in (0, 1, 64, 65, 300, 512, 513, 4096):
        assert kd.bucket_ut(n) == jbb.bucket_ut(n)
    assert kd.UT_BUCKETS == jbb.UT_BUCKETS


@pytest.mark.parametrize("case", ["coherent", "ragged_border"])
def test_plain_kernel_d_int8_matches_jax_and_kernel_b(case):
    rng = np.random.default_rng(11)
    H, W, C, R, S, G = (24, 32, 16, 24, 32, 4) if case == "coherent" \
        else (16, 16, 8, 11, 16, 2)
    q, scale = _int8_table(rng, H, W, C)
    grids = _coherent_grids(rng, R, S) if case == "coherent" else _border_grids(rng, R, S)
    ut = _ut(grids, H, W)
    ref = jbb.block_banded_cosine_scale(
        jnp.asarray(q)[None], jnp.asarray(grids)[:, None], kt=S, ut=ut, n_groups=G,
        pairs=pair_index_lists(V), dequant_scales=jnp.asarray(scale)[None])
    got = kd.block_cosine_prior(torch.tensor(q), torch.tensor(grids),
                                torch.tensor(scale), G, ut)
    assert got.shape == (R, S, G) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[0], atol=1e-2)
    plain_b = kb.cosine_prior_plain(torch.tensor(q), torch.tensor(grids),
                                    torch.tensor(scale), G)
    np.testing.assert_allclose(got.numpy(), plain_b.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["coherent", "ragged_border"])
def test_plain_kernel_d_bf16_matches_jax_and_kernel_b(case):
    rng = np.random.default_rng(14)
    H, W, C, R, S, G = (24, 32, 16, 24, 32, 4) if case == "coherent" \
        else (16, 16, 8, 11, 16, 2)
    feat = rng.normal(0, 1, (V, H, W, 2 * C)).astype(np.float32)
    grids = _coherent_grids(rng, R, S) if case == "coherent" else _border_grids(rng, R, S)
    ut = _ut(grids, H, W)
    tb = torch.tensor(feat).to(torch.bfloat16)
    ref = jbb.block_banded_cosine_scale(
        jnp.asarray(feat).astype(jnp.bfloat16)[None], jnp.asarray(grids)[:, None], kt=S,
        ut=ut, n_groups=G, pairs=pair_index_lists(V))
    got = kd.block_cosine_prior(tb, torch.tensor(grids), None, G, ut)
    assert got.shape == (R, S, G) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[0], atol=1e-2)
    plain_b = kb.cosine_prior_plain(tb, torch.tensor(grids), None, G)
    np.testing.assert_allclose(got.numpy(), plain_b.numpy(), atol=1e-5, rtol=0)


def test_block_route_by_table_dtype():
    """Kernel D takes int8 and bf16 tables at every bucket at S = 128 (bf16
    stages 128 channels a pass up to ut 320, 64 above), f32 tables where
    D' fits (`takes_f32`); otherwise, and with scales on a float table,
    Kernel B."""
    t = {dt: torch.zeros(3, 4, 4, 8, dtype=dt)
         for dt in (torch.int8, torch.bfloat16, torch.float32)}
    for ut in kd.UT_BUCKETS:
        for G in (2, 8):
            assert kd.takes_table(t[torch.int8], torch.ones(3, 8), ut, 128, G)
            assert kd.takes_table(t[torch.bfloat16], None, ut, 128, G)
            assert kd.takes_table(t[torch.float32], None, ut, 128, G) == kd.takes_f32(ut, 128, G)
            assert not kd.takes_table(t[torch.bfloat16], torch.ones(3, 8), ut, 128, G)
    assert kd.channels_per_pass(320, 128, 8, False, itemsize=2) == 128
    assert kd.channels_per_pass(384, 128, 8, False, itemsize=2) == 64
    assert not kd.takes_bf16(512, 512, 2)


def test_plain_kernel_d_f32_matches_jax():
    rng = np.random.default_rng(12)
    H, W, C, R, S, G = 24, 32, 16, 16, 32, 4
    table = rng.normal(0, 1, (V, H, W, 2 * C)).astype(np.float32)
    grids = _coherent_grids(rng, R, S)
    ut = _ut(grids, H, W)
    ref = jbb.block_banded_cosine_scale(
        jnp.asarray(table)[None], jnp.asarray(grids)[:, None], kt=S, ut=ut,
        n_groups=G, pairs=pair_index_lists(V))
    got = kd.block_cosine_prior(torch.tensor(table), torch.tensor(grids), None, G, ut)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[0], atol=2e-5, rtol=1e-5)


def test_plain_kernel_d_overflowed_union_drops_taps():
    """A bucket smaller than the union leaves taps out of it: they add 0, so
    the result stays finite but moves. The renderer never lets this happen:
    pose_prep sends an overflowing scale to Kernel B."""
    rng = np.random.default_rng(13)
    H, W, C, R, S, G = 24, 32, 8, 8, 32, 2
    q, scale = _int8_table(rng, H, W, C)
    grids = _coherent_grids(rng, R, S, spread=1.2)
    assert kd.block_union_size_raw(torch.tensor(grids), H, W) > 64
    args = (torch.tensor(q), torch.tensor(grids), torch.tensor(scale), G)
    small = kd.block_cosine_prior(*args, 64)
    full = kd.block_cosine_prior(*args, _ut(grids, H, W))
    assert bool(torch.isfinite(small).all())
    assert float((small - full).abs().max()) > 1e-3
