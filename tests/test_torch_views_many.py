"""Five to eight source views (`n_src_views`): the port's cond-query
kernels against the JAX package on the CPU, at V = 5, 6 and 8.

The cond-query kernels B, B', D, D' and F take V = 2 to 8 and E 1 to 8
(csrc/views.cuh); their plain versions, which the CPU runs and the card
holds each kernel to, are held here to the JAX kernels (Pallas in interpret
mode) and routes. tests/test_torch_views_many_paths.py holds the gradients,
the render and the training steps at these V.

- plain Kernel B and plain Kernel D on int8 tables at V = 5, 6 and 8
  against JAX `banded_cosine_scale` / `block_banded_cosine_scale`: atol
  1e-2 (the JAX kernels' bf16 stencil weights, as tests/test_torch_views.py);
  plain D against plain B atol 1e-5;
- plain Kernel E at V = 5 against JAX `supercell_color_sample` (atol 2e-2,
  as tests/test_torch_supercell_color.py) and at V = 5, 6 and 8 against
  JAX's gather route (`grid_sample_2d_packed` on the 2x2-packed uint8
  images, the route of `precision.color_block_kernel: false`; atol 1e-3 on
  the 0-255 scale: two roundings of one bilinear blend). JAX's own colour
  kernel stops at V = 5: its lane-major output pads 3V colour rows to 16
  with `jnp.zeros((16 - 3 * V, S))` (matchnerf_tpu/ops/pallas_color.py:173),
  which raises at V = 6; a test pins that fault and the port's answer there;
- plain Kernel F at V = 5 and 8 against JAX `fused_interp_grouped_cosine`
  (atol 1e-5, as tests/test_torch_fused_cosine.py), and the fused route's
  row chunk (`fused_chunk_rays`) at or under its rows at V = 3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_views import _grids, _int8_table, _packed, _ut

from matchnerf_tpu.models.gmflow.gmflow import pair_index_lists
from matchnerf_tpu.ops import pallas_block_banded as jbb
from matchnerf_tpu.ops import pallas_color as jpc
from matchnerf_tpu.ops.grid_sample import grid_sample_2d_packed, pack_2x2
from matchnerf_tpu.ops.pallas_banded import banded_cosine_scale
from matchnerf_tpu.ops.pallas_cond import fused_interp_grouped_cosine as jax_fused
from matchnerf_tpu_torch.models.matchnerf import FUSED_CHUNK_RAYS, fused_chunk_rays
from matchnerf_tpu_torch.ops import block_cosine_prior as kd
from matchnerf_tpu_torch.ops import cosine_prior as kb
from matchnerf_tpu_torch.ops import fused_cosine as kf
from matchnerf_tpu_torch.ops import supercell_color as ke
from torch_threads import one_torch_thread  # noqa: F401

H, W, C, R, S, G = 20, 24, 16, 16, 24, 4


@pytest.mark.parametrize("V", [5, 6, 8])
def test_plain_priors_int8_match_jax(V):
    """Plain B and plain D against the JAX banded and block-banded kernels,
    and against each other, on int8 tables with their [V,(V-1)C] scales:
    the V(V-1)/2 pairs (10, 15, 28) and the mean over them."""
    rng = np.random.default_rng(50 + V)
    feat = rng.normal(0, 1, (V, H, W, (V - 1) * C)).astype(np.float32)
    table, scale = _int8_table(feat)
    grids = _grids(rng, V, R, S)
    ut = _ut(grids, H, W)
    pairs = pair_index_lists(V)
    jscale = jnp.asarray(scale)[None]
    jgrids = jnp.asarray(grids)[:, None]
    ref_b = np.asarray(banded_cosine_scale(_packed(table), jgrids, kt=48, n_groups=G,
                                           pairs=pairs, dequant_scales=jscale))[0]
    ref_d = np.asarray(jbb.block_banded_cosine_scale(
        jnp.asarray(table)[None], jgrids, kt=S, ut=ut, n_groups=G, pairs=pairs,
        dequant_scales=jscale))[0]
    args = (torch.tensor(table), torch.tensor(grids), torch.tensor(scale), G)
    got_b = kb.cosine_prior(*args)
    got_d = kd.block_cosine_prior(*args, ut)
    assert got_b.shape == got_d.shape == (R, S, G)
    for got, ref in ((got_b, ref_b), (got_d, ref_d)):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-2, rtol=0)
    np.testing.assert_allclose(got_d.numpy(), got_b.numpy(), atol=1e-5, rtol=0)


CH, CW, CR, CS = 48, 78, 24, 16          # colour tests: W not a multiple of 4


def _color_case(V, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (V, CH, CW, 3), dtype=np.uint8)
    base = rng.uniform(-1.1, 1.1, (V, CR // 8, 1, CS, 2)).astype(np.float32)
    drift = np.linspace(0, 0.03, 8, dtype=np.float32)[None, None, :, None, None]
    grids = np.ascontiguousarray((base + drift).reshape(V, CR, CS, 2))
    return img, grids


def _jax_gather_colors(img, grids):
    """JAX's colour gather route: each view's 2x2-packed uint8 image
    sampled by `grid_sample_2d_packed` -> [R,S,3V] on the 0-255 scale."""
    V = img.shape[0]
    cols = [np.asarray(grid_sample_2d_packed(pack_2x2(jnp.asarray(img[v:v + 1])),
                                             jnp.asarray(grids[v:v + 1])))[0]
            for v in range(V)]
    return np.concatenate(cols, axis=-1).astype(np.float32)


@pytest.mark.parametrize("V", [5, 6, 8])
def test_plain_kernel_e_matches_jax(V):
    """Plain E at V views against JAX's gather route (atol 1e-3) and, at
    V = 5, the last V JAX's colour kernel takes, against that kernel (atol
    2e-2)."""
    img, grids = _color_case(V, 70 + V)
    tab = ke.build_supercell_colors(torch.tensor(img))
    got = ke.supercell_color_sample(tab, torch.tensor(grids), CH, CW)
    assert got.shape == (CR, CS, 3 * V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_gather_colors(img, grids), atol=1e-3, rtol=0)
    if V == 5:
        ut = ke.bucket_color_ut(ke.color_union_size(torch.tensor(grids), CH, CW))
        assert ut is not None
        ref = jpc.supercell_color_sample(jpc.build_supercell_colors(jnp.asarray(img))[None],
                                         jnp.asarray(grids)[:, None], CH, CW, ut=ut)
        ref = np.moveaxis(np.asarray(ref)[:, 0], 0, 2).reshape(CR, CS, 3 * V)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-2, rtol=0)


def test_jax_color_kernel_fails_at_six_views():
    """The JAX fault the port does not copy: JAX's supercell colour kernel
    raises at V = 6 (its lane-major output's 16 rows hold at most 5 views'
    colours, pallas_color.py:173), where the port's plain E returns the
    colours of JAX's gather route."""
    V = 6
    img, grids = _color_case(V, 80)
    ut = ke.bucket_color_ut(ke.color_union_size(torch.tensor(grids), CH, CW))
    with pytest.raises(TypeError, match="nonnegative"):
        jpc.supercell_color_sample(jpc.build_supercell_colors(jnp.asarray(img))[None],
                                   jnp.asarray(grids)[:, None], CH, CW, ut=ut)
    got = ke.supercell_color_sample(ke.build_supercell_colors(torch.tensor(img)),
                                    torch.tensor(grids), CH, CW)
    np.testing.assert_allclose(got.numpy(), _jax_gather_colors(img, grids), atol=1e-3, rtol=0)


@pytest.mark.parametrize("V", [5, 8])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_plain_kernel_f_matches_jax(V, dtype):
    """Plain F on rows [V,N,4(V-1)C] against JAX `fused_interp_grouped_cosine`
    over the V(V-1)/2 pairs, atol 1e-5."""
    rng = np.random.default_rng(90 + V)
    N, Cf, Gf = 40, 32, 4
    shape = (V, N, 4 * (V - 1) * Cf)
    if dtype == "int8":
        vals = rng.integers(-127, 128, shape).astype(np.float32)
        rows_t = torch.from_numpy(vals).to(torch.int8)
    else:
        vals = rng.standard_normal(shape).astype(np.float32)
        rows_t = torch.from_numpy(vals)
    w = rng.uniform(0, 1, (V, N, 2)).astype(np.float32)
    ref = jax_fused(jnp.asarray(vals), jnp.asarray(w), n_views=V, chunk_c=Cf, n_groups=Gf,
                    pairs=pair_index_lists(V), block_points=8)
    got = kf.fused_interp_grouped_cosine(rows_t, torch.from_numpy(w), Gf)
    assert got.shape == (N, Gf) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_fused_chunk_keeps_rows_at_three_view_size():
    """The fused route gathers V x 4(V-1) table rows a sample: its chunk of
    rays keeps them at or under their count at V = 3 (V = 2 and 3 keep the
    whole FUSED_CHUNK_RAYS), a multiple of 8 rays past V = 3."""
    limit = FUSED_CHUNK_RAYS * 3 * 4 * 2
    assert fused_chunk_rays(2) == fused_chunk_rays(3) == FUSED_CHUNK_RAYS
    assert [fused_chunk_rays(V) for V in (4, 5, 8)] == [4096, 2456, 872]
    for V in range(2, 15):
        rays = fused_chunk_rays(V)
        assert rays * V * 4 * (V - 1) <= limit and rays % 8 == 0, V
    # 8 views at S = 128: 3.2 GB of int8 rows a chunk, 12.8 GB of f32
    assert fused_chunk_rays(8) * 128 * 8 * 4 * 7 * 128 * 4 < 13e9
