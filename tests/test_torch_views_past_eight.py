"""Nine to sixteen source views (`n_src_views`): the port's cond-query
kernels against the JAX package on the CPU, at V = 10 and 16.

Past V = 8 the kernels B, B', D, D' and F run one instance that takes V at
run time, and E stages up to 16 views' colours (csrc/views.cuh
`MAX_V_WIDE`); their plain versions, which the CPU runs and the card holds
each kernel to, are held here to the JAX kernels (Pallas in interpret mode)
and routes, as tests/test_torch_views_many.py holds them at V = 5 to 8.
tests/test_torch_views_past_eight_paths.py holds the gradients, the render
and the training step at V = 10.

- plain Kernel B and plain Kernel D on int8 tables at V = 10 (and 16 in
  tests/test_torch_views_past_eight_sixteen.py: the JAX kernels' 120 pairs
  take ~100 s to trace) against JAX `banded_cosine_scale` /
  `block_banded_cosine_scale`: atol 1e-2 (the JAX kernels' bf16 stencil
  weights); plain D against plain B atol 1e-5;
- plain Kernel B on an int4 table at V = 10 against JAX's XLA int4 route
  (`grid_sample_2d_packed_int4` times the scales; atol 1e-5, as
  tests/test_torch_int4_tables.py);
- plain Kernel E at V = 10 and 16 against JAX's gather route (atol 1e-3 on
  the 0-255 scale; JAX's own colour kernel stops at V = 5);
- plain Kernel F at V = 10 against JAX `fused_interp_grouped_cosine` (atol
  1e-5);
- the Python bounds mirror csrc/views.cuh; the shipped decoder's route is
  Kernel C to V = 13 (Gf + 4V <= 64) and Kernel Cg from V = 14; the fused
  route's chunk at V = 10 and 16; `synth.write_dtu_scene` writes the
  default tree byte for byte as before and up to 20 views, 8 degrees
  apart on each side.
"""
import hashlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_views import _grids, _int8_table, _packed, _ut
from test_torch_views_many import _color_case, _jax_gather_colors

import __graft_entry__ as ge
from matchnerf_tpu.models.gmflow.gmflow import pair_index_lists
from matchnerf_tpu.models.matchnerf import _grouped_cosine
from matchnerf_tpu.ops import pallas_block_banded as jbb
from matchnerf_tpu.ops.grid_sample import (grid_sample_2d_packed_int4, pack_2x2,
                                           pack_int4_channels)
from matchnerf_tpu.ops.pallas_banded import banded_cosine_scale
from matchnerf_tpu.ops.pallas_cond import fused_interp_grouped_cosine as jax_fused
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch.data import synth
from matchnerf_tpu_torch.models import matchnerf as pmn
from matchnerf_tpu_torch.models.decoder.cond_nerf import CondNeRF
from matchnerf_tpu_torch.ops import block_cosine_prior as kd
from matchnerf_tpu_torch.ops import cosine_prior as kb
from matchnerf_tpu_torch.ops import decoder as kc
from matchnerf_tpu_torch.ops import fused_cosine as kf
from matchnerf_tpu_torch.ops import supercell_color as ke
from torch_threads import one_torch_thread  # noqa: F401

H, W, C, R, S, G = 20, 24, 16, 16, 24, 4


def check_priors_int8_match_jax(V):
    """Plain B and plain D against the JAX banded and block-banded kernels,
    and against each other, on int8 tables with their [V,(V-1)C] scales:
    the V(V-1)/2 pairs (45, 120) and the mean over them."""
    rng = np.random.default_rng(150 + V)
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


def test_plain_priors_int8_match_jax_ten_views():
    check_priors_int8_match_jax(10)


def _jax_xla_int4(jtab, grids, scales, n_groups):
    """JAX's XLA int4 route (matchnerf.py:383-388) and the grouped cosine
    over pair_index_lists(V), as tests/test_torch_int4_tables.py at V = 3."""
    V = jtab.shape[1]
    Cq = jtab.shape[-1] // 2 // (V - 1)
    sampled = [grid_sample_2d_packed_int4(jtab[:, v], jnp.asarray(grids[v])[None])
               * jnp.asarray(scales)[v][None, None, None, :] for v in range(V)]
    per_pair = [_grouped_cosine(sampled[i][..., (j - 1) * Cq:j * Cq],
                                sampled[j][..., i * Cq:(i + 1) * Cq], n_groups)
                for (i, j) in pair_index_lists(V)]
    return np.asarray(jnp.stack(per_pair, 0).mean(0))[0]


@pytest.mark.parametrize("G_", [2, 8])
def test_plain_int4_matches_jax_xla_route_ten_views(G_):
    """Plain B on an int4 table of 10 views (uint8 [V,h,w,(V-1)C/2], the
    port's nibble order) against JAX's XLA int4 route on the same codes in
    JAX's layout (pack_int4_channels, then pack_2x2), atol 1e-5."""
    V, h, w, Cq = 10, 12, 14, 128
    rng = np.random.default_rng(160 + G_)
    feat = rng.normal(0, 1, (V, h, w, (V - 1) * Cq)).astype(np.float32)
    scale = np.maximum(np.abs(feat).max(axis=(1, 2), keepdims=True), 1e-12) / 7.0
    q = np.clip(np.round(feat / scale), -8, 7).astype(np.int32)
    port = pmn.pack_int4(torch.from_numpy(q))
    jtab = jax.vmap(lambda f: pack_2x2(f[None])[0])(
        pack_int4_channels(jnp.asarray(q + 8)))[None]
    grids = _grids(rng, V, 8, 16)
    scales = scale[:, 0, 0].astype(np.float32)
    got = kb.cosine_prior(port, torch.from_numpy(grids), torch.from_numpy(scales), G_)
    assert port.shape == (V, h, w, (V - 1) * Cq // 2) and got.shape == (8, 16, G_)
    np.testing.assert_allclose(got.numpy(), _jax_xla_int4(jtab, grids, scales, G_),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("V", [10, 16])
def test_plain_kernel_e_matches_jax(V):
    """Plain E at V views against JAX's gather route (atol 1e-3 on the
    0-255 scale), [R,S,3V] in the decoder's colour layout."""
    img, grids = _color_case(V, 170 + V)
    tab = ke.build_supercell_colors(torch.tensor(img))
    got = ke.supercell_color_sample(tab, torch.tensor(grids), img.shape[1], img.shape[2])
    assert got.shape == (grids.shape[1], grids.shape[2], 3 * V)
    np.testing.assert_allclose(got.numpy(), _jax_gather_colors(img, grids), atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_plain_kernel_f_matches_jax_ten_views(dtype):
    """Plain F on rows [10,N,4*9C] against JAX `fused_interp_grouped_cosine`
    over the 45 pairs, atol 1e-5."""
    V, N, Cf, Gf = 10, 24, 32, 4
    rng = np.random.default_rng(180)
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


def test_view_bounds_mirror_the_header():
    """ops/cosine_prior.py's MAX_V and MAX_V_WIDE are csrc/views.cuh's; the
    kernels take V = 2 to 16 (E: 1 to 16); the fused route's chunk keeps its
    rows at or under their V = 3 size (544 rays at V = 10, 200 at 16)."""
    with open(os.path.join(os.path.dirname(kb.__file__), "..", "csrc", "views.cuh")) as f:
        header = f.read()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", header))
    assert (kb.MAX_V, kb.MAX_V_WIDE) == (int(consts["MAX_V"]), int(consts["MAX_V_WIDE"]))
    assert kb.VIEWS == tuple(range(2, 17)) and ke.MAX_VIEWS == 16
    assert [pmn.fused_chunk_rays(V) for V in (9, 10, 12, 16)] == [680, 544, 368, 200]
    for V in range(9, 17):
        rays = pmn.fused_chunk_rays(V)
        assert rays * V * 4 * (V - 1) <= pmn.FUSED_CHUNK_RAYS * 24 and rays % 8 == 0, V


def test_route_reads_one_images_table(monkeypatch):
    """`takes_table` takes one image's table [V,h,w,Cc]: at S = 128 an int8
    table of 10 views of 64x80 cells takes Kernel D at bucket 192 (G = 2),
    and one of 16 views too, at every bucket (the pair layout: before it
    the taps and fractions of 16 views outgrew the block's shared memory
    and D took none), and a batched [B,V,h,w,Cc] table raises (read as V = 1
    views of B*V x h cells, it once sent such a scale to D, whose wrapper
    refused it); `query_cond_info` asks it about each scale's [V,h,w,Cc]."""
    meta = lambda V: torch.empty(V, 64, 80, (V - 1) * 128, dtype=torch.int8, device="meta")
    ones = torch.ones(1)
    assert kd.takes_table(meta(10), ones, 192, 128, 2)
    assert kd.takes_table(meta(16), ones, 192, 128, 2)
    assert all(kd.takes_table(meta(16), ones, u, 128, G_)
               for u in kd.UT_BUCKETS for G_ in (2, 8))
    with pytest.raises(ValueError, match="one image's"):
        kd.takes_table(meta(16)[None], ones, 192, 128, 2)

    from matchnerf_tpu_torch.config import dtu_eval_config
    from matchnerf_tpu_torch.renderer import Renderer
    V = 10
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=8)))
    cfg.n_src_views = V
    cfg.precision = DotDict(dict(dtu_eval_config().precision))
    model = pmn.init_matchnerf(cfg, torch.Generator().manual_seed(0)).eval()
    d = ge._synthetic_inputs(cfg, 1, 16, 16, R=8)
    asked = []
    real = pmn.takes_table
    monkeypatch.setattr(pmn, "takes_table", lambda t, *a: asked.append(tuple(t.shape))
                        or real(t, *a))
    Renderer(cfg, model, "cpu").forward({"images": d["images"], "extrinsics": d["poses"],
                                         "intrinsics": d["intr"],
                                         "near_fars": d["near_fars"]}, mode="test")
    assert asked and all(len(sh) == 4 and sh[0] == V for sh in asked), asked


def _shipped_decoder(V):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=128)))
    cfg.n_src_views = V
    return CondNeRF(cfg), cfg


@pytest.mark.parametrize("V,route", [(9, "C"), (13, "C"), (14, "Cg"), (16, "Cg")])
def test_shipped_decoder_route_past_eight_views(V, route):
    """The shipped CondNeRF (cos_n_group [2, 8]: Gf = 10) takes Kernel C
    while its conditioning width Gf + 4V is at most 64 (V <= 13) and Kernel
    Cg from V = 14 (up to 128: V <= 29), at S = 128."""
    dec, cfg = _shipped_decoder(V)
    assert 10 + 4 * V in dec.pts_bias.weight.shape
    assert kc.decoder_route(dec, cfg, 128) == route


def _tree_sha(root):
    h = hashlib.sha256()
    for d, dirs, names in sorted(os.walk(root)):
        dirs.sort()
        for n in sorted(names):
            p = os.path.join(d, n)
            h.update(os.path.relpath(p, root).encode())
            with open(p, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


# `write_dtu_scene(root, meta, W=64, H=64)` and with n_views=11, written by
# the tree before the arc went past 12 views
DEFAULT_TREE_SHA256 = "ef8170cefc7be6182dacfe40697a1f466151171b81f06e80a475f2e61166ecfb"
ELEVEN_TREE_SHA256 = "08fc1bfad98244154b9f3ffea5c2f07575718d27689a6284d93d9c7a8c4c6783"


def test_write_dtu_scene_past_twelve_views(tmp_path):
    """The default tree and the 11-view tree byte for byte as before the
    arc grew; 20 views (ids 20-25, then 19 down to 6) at the angles of
    the arc, the first 12 as before, on each side of 0 degrees 8 apart."""
    from test_torch_synth import _camera_angles
    for name, n in (("default", 6), ("eleven", 11)):
        synth.write_dtu_scene(str(tmp_path / name / "DTU"), str(tmp_path / name / "meta"),
                              W=64, H=64, **({} if n == 6 else {"n_views": n}))
    assert _tree_sha(tmp_path / "default") == DEFAULT_TREE_SHA256
    assert _tree_sha(tmp_path / "eleven") == ELEVEN_TREE_SHA256
    ids = synth.dtu_scene_view_ids(20)
    assert ids == (20, 21, 22, 23, 24, 25) + tuple(range(19, 5, -1))
    synth.write_dtu_scene(str(tmp_path / "twenty" / "DTU"), str(tmp_path / "twenty" / "meta"),
                          W=32, H=32, n_views=20)
    angles = _camera_angles(tmp_path / "twenty", ids)
    np.testing.assert_allclose(angles, synth._DTU_SCENE_ANGLES, atol=1e-5)
    assert synth._DTU_SCENE_ANGLES[:12] == (-4.0, -12.0, 4.0, 12.0, 0.0, -20.0, 20.0, -28.0,
                                            28.0, -36.0, 36.0, -44.0)
    for side in (angles[angles > 1], -angles[angles < -1]):    # each side of 0: 4, 12, ...
        np.testing.assert_allclose(np.diff(np.sort(side)), 8.0, atol=1e-5)
    with pytest.raises(ValueError, match="n_views=21"):
        synth.dtu_scene_view_ids(21)
