"""Kernel F (fused interpolation + grouped cosine on tap rows) and the fused
cond route, the port against the JAX package on the CPU.

(a) `fused_interp_grouped_cosine_plain` against the JAX Pallas kernel
    `pallas_cond.py::fused_interp_grouped_cosine` in interpret mode, as
    tests/test_pallas_cond.py runs it (V=3, C=32, N=100: the padding path
    runs), on f32, bf16 and int8-valued rows, G in {2, 8}: atol 1e-5.
(b) `tap_rows_and_weights` on the unpacked table against the JAX
    `packed_rows_and_weights(pack_2x2(table))`, grid points on and beyond
    the border included: rows bit for bit, weights within 1e-7.
(c) the port's `query_cond_info(fused_cosine=True)` against the JAX one on
    the same encoder features: against the JAX fused route on f32 and bf16
    tables, and against the JAX UNFUSED route on int8 tables, all at atol
    2e-5. On int8 tables the JAX fused route feeds raw int8 rows to its
    kernel and drops the per-(view, channel) dequantisation scales, which
    moves the cosines by up to 0.222 (mean 0.067) at this configuration; the
    port applies the scales after interpolation, as the unfused route does.
    `test_jax_fused_route_drops_int8_scales` measures that gap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu import camera as jcam
from matchnerf_tpu.models import matchnerf as jmn
from matchnerf_tpu.ops.grid_sample import pack_2x2, packed_rows_and_weights
from matchnerf_tpu.ops.pallas_cond import fused_interp_grouped_cosine as jax_fused
from matchnerf_tpu_torch.models import matchnerf as pmn
from matchnerf_tpu_torch.ops.fused_cosine import (fused_interp_grouped_cosine,
                                                  fused_interp_grouped_cosine_plain)
from matchnerf_tpu_torch.ops.grid_sample import tap_rows_and_weights
from torch_threads import one_torch_thread  # noqa: F401

PAIRS = [(0, 1), (0, 2), (1, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("G", [2, 8])
def test_plain_matches_jax_kernel(dtype, G):
    rng = np.random.default_rng(0)
    V, N, C = 3, 100, 32
    if dtype == "int8":
        vals = rng.integers(-127, 128, (V, N, 4 * 2 * C)).astype(np.float32)
        rows_t = torch.from_numpy(vals).to(torch.int8)
    else:
        rows_t = torch.from_numpy(rng.standard_normal((V, N, 8 * C)).astype(np.float32))
        if dtype == "bfloat16":
            rows_t = rows_t.bfloat16()
        vals = rows_t.float().numpy()
    w = rng.uniform(0, 1, (V, N, 2)).astype(np.float32)
    jrows = jnp.asarray(vals, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ref = jax_fused(jrows, jnp.asarray(w), n_views=V, chunk_c=C, n_groups=G, pairs=PAIRS,
                    block_points=32)
    got = fused_interp_grouped_cosine(rows_t, torch.from_numpy(w), G)
    assert got.shape == (N, G) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_plain_applies_scales_after_interpolation():
    """Scales multiply the interpolated vector: the same as scaling the taps
    (interpolation is linear per channel)."""
    rng = np.random.default_rng(1)
    V, N, C = 3, 64, 32
    rows = torch.from_numpy(rng.integers(-127, 128, (V, N, 8 * C)).astype(np.int8))
    w = torch.from_numpy(rng.uniform(0, 1, (V, N, 2)).astype(np.float32))
    scales = torch.from_numpy(rng.uniform(1e-3, 2e-2, (V, 2 * C)).astype(np.float32))
    got = fused_interp_grouped_cosine_plain(rows, w, 8, scales)
    scaled = rows.float() * scales.repeat(1, 4)[:, None, :]
    torch.testing.assert_close(got, fused_interp_grouped_cosine_plain(scaled, w, 8),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_tap_rows_match_jax_packed_rows(dtype):
    rng = np.random.default_rng(2)
    H, W, C = 9, 13, 6
    if dtype == "int8":
        table = rng.integers(-127, 128, (H, W, C)).astype(np.int8)
    else:
        table = rng.standard_normal((H, W, C)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (5, 7, 2)).astype(np.float32)
    grid[0, :, 0] = 1.0                           # on the right border
    grid[1, :, 1] = -1.0                          # on the top border
    grid[2, :3] = [[1.0, 1.0], [-1.0, -1.0], [2.0, -2.0]]
    grid[3] = np.stack([np.linspace(-1, 1, 7), np.linspace(1, -1, 7)], -1)
    rows, wx, wy = packed_rows_and_weights(pack_2x2(jnp.asarray(table)[None]),
                                           jnp.asarray(grid)[None])
    got_rows, got_w = tap_rows_and_weights(torch.from_numpy(table), torch.from_numpy(grid))
    assert got_rows.dtype == torch.from_numpy(table).dtype
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(rows[0]))
    np.testing.assert_allclose(got_w.numpy(), np.concatenate([wx[0], wy[0]], -1),
                               atol=1e-7, rtol=0)
    out = torch.empty_like(got_rows)
    assert tap_rows_and_weights(torch.from_numpy(table), torch.from_numpy(grid),
                                out=out)[0] is out
    assert torch.equal(out, got_rows)


def _cond_setup():
    """The JAX tiny configuration of test_pallas_cond.py: features, world
    points and cameras, shared by both packages."""
    cfg = ge._tiny_cfg(n_layers=1, sample_intvs=8)
    B, H, W, R = 1, 16, 16, 32
    params = jmn.init_matchnerf(jax.random.PRNGKey(0), cfg)
    d = ge._synthetic_inputs(cfg, B, H, W, R)
    ref = jnp.asarray(d["images"][:, :3])
    feats = jmn.encode(params, cfg, ref)
    center, ray = jcam.get_center_and_ray(jnp.asarray(d["pix"]),
                                          jnp.asarray(d["intr"][:, -1]),
                                          jnp.asarray(d["tgt_c2w"]))
    depth = jmn.sample_depth(cfg, jnp.asarray(d["near_fars"][:, -1]), B, R)
    pts = jcam.get_3d_points_from_depth(center, ray, depth, multi_samples=True)
    cams = (d["poses"][:, :-1, :3, :], d["intr"][:, :-1], d["near_fars"][:, :-1])
    return cfg, (H, W), ref, feats, pts, cams


JAX_DTYPES = {"float32": None, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
PORT_DTYPES = {"float32": None, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _jax_cond(cfg, hw, ref, feats, pts, cams, dtype, fused):
    tables = jmn.prepare_sampling_tables(cfg, feats, ref, feat_dtype=JAX_DTYPES[dtype])
    cond, _ = jmn.query_cond_info(cfg, pts, *(jnp.asarray(c) for c in cams), ref, feats,
                                  *hw, tables=tables, fused_cosine=fused)
    return {k: np.asarray(v) for k, v in cond.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_fused_cond_query_matches_jax(dtype, monkeypatch):
    cfg, hw, ref, feats, pts, cams = _cond_setup()
    # the JAX fused route on f32 and bf16 tables; on int8 tables the unfused
    # route, which applies the dequantisation scales (see the module docstring)
    want = _jax_cond(cfg, hw, ref, feats, pts, cams, dtype, fused=dtype != "int8")
    tfeats = [torch.from_numpy(np.array(f)) for f in feats]
    tables = pmn.prepare_sampling_tables(cfg, tfeats, torch.from_numpy(np.asarray(ref)),
                                         feat_dtype=PORT_DTYPES[dtype])
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    calls = []
    real = pmn.fused_interp_grouped_cosine
    monkeypatch.setattr(pmn, "fused_interp_grouped_cosine",
                        lambda *a: calls.append(1) or real(*a))
    cond, _ = pmn.query_cond_info(cfg, t(pts), *(t(c) for c in cams), tables, *hw,
                                  fused_cosine=True)
    assert len(calls) == 2                        # Kernel F's wrapper at both scales
    np.testing.assert_allclose(cond["feat_info"].numpy(), want["feat_info"], atol=2e-5,
                               rtol=0)
    # colours: the JAX packed sampler's nested lerp against the port's
    # four-weight sum (grid_sample_2d), two roundings of one bilinear blend
    np.testing.assert_allclose(cond["color_info"].numpy(), want["color_info"], atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(cond["mask_info"].numpy(), want["mask_info"])


def test_fused_route_chunks_rays(monkeypatch):
    """Rows are gathered FUSED_CHUNK_RAYS rays at a time; the result does not
    depend on the chunk."""
    cfg, hw, ref, feats, pts, cams = _cond_setup()
    tfeats = [torch.from_numpy(np.array(f)) for f in feats]
    tables = pmn.prepare_sampling_tables(cfg, tfeats, torch.from_numpy(np.asarray(ref)),
                                         feat_dtype=torch.int8)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    args = (cfg, t(pts), *(t(c) for c in cams), tables, *hw)
    whole, _ = pmn.query_cond_info(*args, fused_cosine=True)
    monkeypatch.setattr(pmn, "FUSED_CHUNK_RAYS", 7)
    chunked, _ = pmn.query_cond_info(*args, fused_cosine=True)
    torch.testing.assert_close(chunked["feat_info"], whole["feat_info"], atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_jax_fused_route_drops_int8_scales(dtype):
    """The finding the port does not copy: the JAX fused route equals the
    JAX unfused route on f32 and bf16 tables (1.8e-7 and 2.4e-7 here) but
    not on int8 tables (max |d| 0.222, mean 0.067, on cosines in
    [0.41, 0.99])."""
    cfg, hw, ref, feats, pts, cams = _cond_setup()
    fused = _jax_cond(cfg, hw, ref, feats, pts, cams, dtype, fused=True)["feat_info"]
    unfused = _jax_cond(cfg, hw, ref, feats, pts, cams, dtype, fused=False)["feat_info"]
    gap = np.abs(fused - unfused)
    if dtype == "int8":
        assert float(gap.max()) > 0.1, (float(gap.max()), float(gap.mean()))
    else:
        assert float(gap.max()) <= 1e-6, float(gap.max())
