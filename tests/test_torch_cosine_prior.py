"""Kernel B (grouped-cosine matching prior) of the PyTorch port vs the JAX
package, on the CPU.

- The port's unpacked int8 tables equal the JAX `view_feats_unpacked` bit
  for bit (same abs-max / 127, round half to even, clip).
- The plain Kernel B matches `banded_cosine_scale` (Pallas, interpret mode)
  on f32 tables at atol 2e-5 (f32 one-hot matmul vs direct interpolation).
- On int8 tables it matches `banded_cosine_scale` at atol 1e-2, the bound
  tests/test_pallas_banded.py sets for that kernel's bf16 bilinear weights,
  and the JAX direct packed-gather path at atol 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.models.gmflow.gmflow import pair_index_lists
from matchnerf_tpu.models.matchnerf import _grouped_cosine
from matchnerf_tpu.models.matchnerf import \
    prepare_sampling_tables as jax_prepare_tables
from matchnerf_tpu.ops.grid_sample import grid_sample_2d_packed, pack_2x2
from matchnerf_tpu.ops.pallas_banded import banded_cosine_scale
from matchnerf_tpu_torch.models.matchnerf import \
    prepare_sampling_tables as torch_prepare_tables
from matchnerf_tpu_torch.ops import cosine_prior as tcp

V, H, W, C = 3, 24, 32, 16
R, S, G = 16, 32, 4


def _coherent_grids(rng):
    """Monotone straight segments per ray (epipolar-like), [V,R,S,2]."""
    starts = rng.uniform(-1.1, 0.3, (V, R, 2))
    ends = starts + rng.uniform(0.05, 0.6, (V, R, 2))
    t = np.linspace(0, 1, S)[None, None, :, None]
    return (starts[:, :, None, :] * (1 - t) + ends[:, :, None, :] * t).astype(np.float32)


def _packed(table):
    """[V,h,w,Cc] -> JAX pack_2x2 tables [1,V,h,w,4Cc]."""
    return jax.vmap(lambda f: pack_2x2(f[None])[0])(jnp.asarray(table))[None]


def _jax_direct(packed, grids, scales):
    sampled = []
    for v in range(V):
        s = grid_sample_2d_packed(packed[:, v], jnp.asarray(grids[v])[None]).astype(jnp.float32)
        if scales is not None:
            s = s * jnp.asarray(scales)[v][None, None, None, :]
        sampled.append(s)
    per_pair = []
    for (i, j) in pair_index_lists(V):
        fa = sampled[i][..., (j - 1) * C:j * C]
        fb = sampled[j][..., i * C:(i + 1) * C]
        per_pair.append(_grouped_cosine(fa, fb, G))
    return np.asarray(jnp.stack(per_pair, 0).mean(0))[0]


def test_int8_tables_bit_exact():
    cfg = ge._tiny_cfg(n_layers=1)
    rng = np.random.default_rng(0)
    feats = [rng.normal(0, 1.5, (1, 3, 2, h, w, 8)).astype(np.float32)
             for (h, w) in ((4, 6), (8, 12))]
    imgs = rng.uniform(-0.1, 1.1, (1, 3, 16, 24, 3)).astype(np.float32)
    ref = jax_prepare_tables(cfg, [jnp.asarray(f) for f in feats], jnp.asarray(imgs),
                             feat_dtype=jnp.int8, color_dtype=jnp.uint8,
                             keep_unpacked=True)
    got = torch_prepare_tables(cfg, [torch.tensor(f) for f in feats], torch.tensor(imgs),
                               feat_dtype=torch.int8, color_dtype=torch.uint8)
    for s in range(2):
        assert got["view_feats"][s].dtype == torch.int8
        np.testing.assert_array_equal(got["view_feats"][s].numpy(),
                                      np.asarray(ref["view_feats_unpacked"][s]))
        np.testing.assert_array_equal(got["view_feat_scales"][s].numpy(),
                                      np.asarray(ref["view_feat_scales"][s]))
    # the packed colour table's first tap block is the u8 image itself
    np.testing.assert_array_equal(got["colors"].numpy(),
                                  np.asarray(ref["colors"])[..., :3])
    assert got["color_scale"] == ref["color_scale"]


def test_plain_kernel_b_f32_matches_banded_kernel():
    rng = np.random.default_rng(1)
    table = rng.normal(0, 1, (V, H, W, 2 * C)).astype(np.float32)
    grids = _coherent_grids(rng)
    ref = banded_cosine_scale(_packed(table), jnp.asarray(grids)[:, None], kt=48,
                              n_groups=G, pairs=pair_index_lists(V))
    got = tcp.cosine_prior(torch.tensor(table), torch.tensor(grids), None, G)
    assert got.shape == (R, S, G)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[0], atol=2e-5, rtol=1e-5)


def test_plain_kernel_b_int8_matches_banded_and_direct():
    rng = np.random.default_rng(2)
    feat = rng.normal(0, 1, (V, H, W, 2 * C)).astype(np.float32)
    scale = np.maximum(np.abs(feat).max(axis=(1, 2)), 1e-12) / 127.0     # [V,Cc]
    q = np.clip(np.round(feat / scale[:, None, None]), -127, 127).astype(np.int8)
    grids = _coherent_grids(rng)
    packed = _packed(q)
    ref_kernel = banded_cosine_scale(packed, jnp.asarray(grids)[:, None], kt=48,
                                     n_groups=G, pairs=pair_index_lists(V),
                                     dequant_scales=jnp.asarray(scale)[None])
    ref_direct = _jax_direct(packed, grids, scale)
    got = tcp.cosine_prior(torch.tensor(q), torch.tensor(grids),
                           torch.tensor(scale.astype(np.float32)), G).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_kernel)[0], atol=1e-2)
    np.testing.assert_allclose(got, ref_direct, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("n_groups", [1, 8])
def test_grouped_cosine_matches_jax(n_groups):
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, (2, 5, 7, 16)).astype(np.float32)
    b = rng.normal(0, 1, (2, 5, 7, 16)).astype(np.float32)
    b[0, 0, 0] = 0.0                       # zero vector: the eps clamp engages
    ref = _grouped_cosine(jnp.asarray(a), jnp.asarray(b), n_groups)
    got = tcp.grouped_cosine(torch.tensor(a), torch.tensor(b), n_groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
