"""int4 sampling tables and per-scale `cond_sample_dtype` lists: the port
against the JAX package on the CPU.

(a) `renderer.cond_sample_dtype` takes a per-scale list as the JAX function
    does (renderer.py:30-47): `['int8', 'bfloat16']` and `['int4', 'int8']`
    give those table dtypes, not f32 (the parent commit turned every list
    into f32 tables and raised on int4). `prepare_sampling_tables` on the
    JAX encoder's features builds, per scale, the tables JAX builds: int4
    codes (decoded from the nibbles) equal to JAX's, scales within 1e-7
    relative, for int4, int4p99.9 and mixed lists.
(b) the int4pXX.X percentile past 2^24 elements (a V = 4 map,
    [1,4,160,128,384], 31.5 M; torch.quantile refuses a flattened input of
    that size): scales and codes equal to JAX `prepare_sampling_tables`'s.
(c) `cosine_prior_plain` on int4 tables against JAX's XLA int4 route
    (`grid_sample_2d_packed_int4` times the scales, then the grouped
    cosine) at 1e-5, and against JAX's Pallas int4 branch
    (`banded_cosine_scale`, interpret mode, as
    test_prepare_tables_int4_query_paths_agree runs it) at that test's
    2e-2: the Pallas branch rounds its folded tap weights to bf16, the port
    interpolates the exact codes with f32 weights, as the XLA route does.
    The gap on these cases: max |d| 5.0e-4 at G = 2 and 1.1e-3 at G = 8
    (mean 8e-5 and 1.6e-4), where the port and the XLA route differ by at
    most 1.2e-7 (`test_jax_pallas_int4_gap`).
(d) the whole slice: `Renderer` images (the plain twins of Kernels A-F on
    the CPU) against the JAX renderer on the same weights (`weights.py`),
    >= 60 dB agreement PSNR, for int4, [int4, int8] and int4p99.9 on the
    block route and [int8, int4] on the fused route, each held against the
    JAX direct route (`banded_kernel: false`, the XLA int4 sampler), as
    test_torch_fused_cosine.py holds F's int8 route to the JAX unfused one;
    each scale's route is checked (an int4 scale on Kernel B's wrapper,
    never D or F).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.models import matchnerf as jmn
from matchnerf_tpu.models.matchnerf import _grouped_cosine
from matchnerf_tpu.ops.grid_sample import (grid_sample_2d_packed_int4, pack_2x2,
                                           pack_int4_channels, unpack_int4_rows)
from matchnerf_tpu.ops.pallas_banded import banded_cosine_scale
from matchnerf_tpu.renderer import Renderer as JaxRenderer
from matchnerf_tpu.renderer import cond_sample_dtype as jax_cond_sample_dtype
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch.config import dtu_eval_config
from matchnerf_tpu_torch.models import matchnerf as pmn
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF
from matchnerf_tpu_torch.ops import block_cosine_prior as kd
from matchnerf_tpu_torch.ops import cosine_prior as kb
from matchnerf_tpu_torch.renderer import Renderer, cond_sample_dtype
from matchnerf_tpu_torch.weights import state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401

PAIRS = [(0, 1), (0, 2), (1, 2)]
H, W = 32, 32


def _cfg(dtype):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=8)))
    cfg.precision = DotDict({"cond_sample_dtype": dtype})
    return cfg


@pytest.mark.parametrize("value,want", [
    (["int8", "bfloat16"], [torch.int8, torch.bfloat16]),
    (["int4", "int8"], ["int4", torch.int8]),
    (["int8", "int4p99.9"], [torch.int8, "int4p99.9"]),
    ("int4", "int4"), ("int4p99.5", "int4p99.5"), ("bf16", torch.bfloat16),
    ("int8", torch.int8), ("float32", torch.float32), ("fp8", torch.float32)])
def test_cond_sample_dtype_per_scale(value, want):
    """One entry per scale, as JAX's; a name JAX does not know maps to f32."""
    got = cond_sample_dtype(_cfg(value))
    assert got == want
    names = {torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    as_jax = ([names.get(g, g) for g in got] if isinstance(got, list)
              else names.get(got, got))
    assert as_jax == jax_cond_sample_dtype(_cfg(value))


def _jax_feats(n_views=3, h=32, w=32):
    cfg = ge._tiny_cfg(n_layers=1, sample_intvs=8)
    cfg.n_src_views = n_views
    params = jmn.init_matchnerf(jax.random.PRNGKey(0), cfg)
    d = ge._synthetic_inputs(cfg, 1, h, w, 8)
    ref = jnp.asarray(d["images"][:, :n_views])
    return cfg, ref, jmn.encode(params, cfg, ref)


def _jax_codes(table):
    """JAX's int4 table [B,V,h,w,4*Cc/2] (pack_2x2 of pack_int4_channels) ->
    each cell's codes [B,V,h,w,Cc] in channel order (its own tap)."""
    Cc = table.shape[-1] // 2
    return np.asarray(unpack_int4_rows(table, jnp.int32))[..., :Cc]


def _check_tables(jt, pt, dtypes):
    for s, dt in enumerate(dtypes):
        jf, pf = jt["view_feats"][s], pt["view_feats"][s]
        js, ps = jt["view_feat_scales"][s], pt["view_feat_scales"][s]
        if pmn.is_int4(dt):
            assert pf.dtype == torch.uint8 and jf.dtype == jnp.uint8
            Cc = jf.shape[-1] // 2
            assert tuple(pf.shape) == (*jf.shape[:-1], Cc // 2)
            np.testing.assert_array_equal(kb.unpack_int4(pf).numpy(), _jax_codes(jf))
            np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-7, atol=0)
        elif dt == torch.int8:
            Cc = jf.shape[-1] // 4
            assert pf.dtype == torch.int8
            np.testing.assert_array_equal(pf.numpy(), np.asarray(jf)[..., :Cc])
            np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-7, atol=0)
        else:
            Cc = jf.shape[-1] // 4
            assert pf.dtype == dt and js is None and ps is None
            np.testing.assert_array_equal(pf.float().numpy(),
                                          np.asarray(jf[..., :Cc].astype(jnp.float32)))


@pytest.mark.parametrize("value", ["int4", "int4p99.9", ["int4", "int8"],
                                   ["int8", "int4p99.9"], ["int8", "bfloat16"]])
def test_tables_match_jax(value):
    """The port's tables per scale equal JAX `prepare_sampling_tables`'s on
    the same encoder features: int4 codes exactly, scales to 1e-7."""
    cfg, ref, feats = _jax_feats()
    cfg.precision = DotDict({"cond_sample_dtype": value})
    pdt = cond_sample_dtype(cfg)
    jt = jmn.prepare_sampling_tables(cfg, feats, ref,
                                     feat_dtype=jax_cond_sample_dtype(cfg))
    pt = pmn.prepare_sampling_tables(cfg, [torch.from_numpy(np.array(f)) for f in feats],
                                     torch.from_numpy(np.array(ref)), feat_dtype=pdt)
    dtypes = pdt if isinstance(pdt, list) else [pdt] * len(feats)
    _check_tables(jt, pt, dtypes)
    # the codes span the int4 range: abs-max ones reach +-7, none is -8
    for s, dt in enumerate(dtypes):
        if pmn.is_int4(dt):
            codes = kb.unpack_int4(pt["view_feats"][s])
            assert float(codes.min()) in (-8.0, -7.0) and float(codes.max()) == 7.0
            if dt == "int4":
                assert float(codes.min()) == -7.0


def test_percentile_past_2_24_matches_jax():
    """int4p99.9 on a V = 4 map of 160x128 cells (31.5 M elements, past
    torch.quantile's 2^24 limit): scales and codes equal JAX's."""
    V, h, w, C = 4, 160, 128, 128
    rng = np.random.default_rng(5)
    P = V * (V - 1) // 2
    gain = rng.uniform(0.2, 3.0, (1, P, 2, 1, 1, C)).astype(np.float32)
    feats = rng.standard_normal((1, P, 2, h, w, C), dtype=np.float32) * gain
    imgs = rng.uniform(0, 1, (1, V, 8, 8, 3)).astype(np.float32)
    cfg = ge._tiny_cfg(n_layers=1)
    cfg.n_src_views = V
    assert V * h * w * (V - 1) * C > 2 ** 24
    pt = pmn.prepare_sampling_tables(cfg, [torch.from_numpy(feats)], torch.from_numpy(imgs),
                                     feat_dtype=["int4p99.9"])
    jt = jmn.prepare_sampling_tables(cfg, [jnp.asarray(feats)], jnp.asarray(imgs),
                                     feat_dtype=["int4p99.9"])
    np.testing.assert_array_equal(pt["view_feat_scales"][0].numpy(),
                                  np.asarray(jt["view_feat_scales"][0]))
    np.testing.assert_array_equal(kb.unpack_int4(pt["view_feats"][0]).numpy(),
                                  _jax_codes(jt["view_feats"][0]))


def _coherent_grids(rng, V, R, S):
    """Straight per-ray segments (tests/test_pallas_banded.py's)."""
    starts = rng.uniform(-0.9, 0.3, (V, R, 2))
    ends = starts + rng.uniform(0.05, 0.5, (V, R, 2))
    t = np.linspace(0, 1, S)[None, None, :, None]
    return (starts[:, :, None, :] * (1 - t) + ends[:, :, None, :] * t).astype(np.float32)


def _int4_case(seed, V=3, h=24, w=24, C=128, R=16, S=32):
    """An int4 table in both layouts from the same codes: the port's
    [V,h,w,Cc/2] (pack_int4) and JAX's pack_2x2 of pack_int4_channels
    [1,V,h,w,Cc*2]; the scales [V,Cc]; coherent grids [V,R,S,2]."""
    rng = np.random.default_rng(seed)
    Cc = (V - 1) * C
    feat = rng.normal(0, 1, (V, h, w, Cc)).astype(np.float32)
    scale = np.maximum(np.abs(feat).max(axis=(1, 2), keepdims=True), 1e-12) / 7.0
    q = np.clip(np.round(feat / scale), -8, 7).astype(np.int32)
    port = pmn.pack_int4(torch.from_numpy(q))
    jax_tab = jax.vmap(lambda f: pack_2x2(f[None])[0])(pack_int4_channels(jnp.asarray(q + 8)))
    grids = _coherent_grids(rng, V, R, S)
    return port, jax_tab[None], scale[:, 0, 0].astype(np.float32), grids


def _jax_xla_int4(jtab, grids, scales, G):
    """JAX's XLA int4 route (matchnerf.py:383-388) and the grouped cosine."""
    V = jtab.shape[1]
    C = jtab.shape[-1] // 2 // (V - 1)
    sampled = [grid_sample_2d_packed_int4(jtab[:, v], jnp.asarray(grids[v])[None])
               * jnp.asarray(scales)[v][None, None, None, :] for v in range(V)]
    per_pair = [_grouped_cosine(sampled[i][..., (j - 1) * C:j * C], sampled[j][..., i * C:(i + 1) * C],
                                G) for (i, j) in PAIRS]
    return np.asarray(jnp.stack(per_pair, 0).mean(0))[0]


@pytest.mark.parametrize("G", [2, 8])
def test_plain_int4_matches_jax_xla_route(G):
    port, jtab, scales, grids = _int4_case(8)
    got = kb.cosine_prior(port, torch.from_numpy(grids), torch.from_numpy(scales), G)
    assert got.shape == (16, 32, G) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_xla_int4(jtab, grids, scales, G), atol=1e-5,
                               rtol=0)


def test_jax_pallas_int4_gap():
    """The JAX Pallas int4 branch (bf16 tap weights) against the port's
    plain twin (f32 weights): within the JAX test's 2e-2, and measurably
    apart (the bf16 rounding the port does not copy)."""
    port, jtab, scales, grids = _int4_case(9)
    got = kb.cosine_prior_plain(port, torch.from_numpy(grids), torch.from_numpy(scales), 2)
    pallas = banded_cosine_scale(jtab, jnp.asarray(grids)[:, None], kt=48, n_groups=2,
                                 pairs=PAIRS, dequant_scales=jnp.asarray(scales)[None])
    gap = np.abs(got.numpy() - np.asarray(pallas)[0])
    assert float(gap.max()) <= 2e-2, float(gap.max())
    assert float(gap.max()) > 1e-5, float(gap.max())


def test_int4_table_checks():
    """Kernel B takes uint8 int4 tables [V,h,w,(V-1)*64] with scales; D's
    route never takes them; a wrapper without scales raises."""
    kb.check_table("t", torch.empty(3, 4, 5, 128, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="64"):
        kb.check_table("t", torch.empty(3, 4, 5, 256, dtype=torch.uint8, device="meta"))
    table = torch.zeros(3, 4, 5, 128, dtype=torch.uint8)
    assert not kd.takes_table(table, torch.ones(3, 256), 96, 128, 8)
    with pytest.raises(ValueError, match="scales"):
        kb.cosine_prior(table, torch.zeros(3, 2, 4, 2), None, 8)


def _setup(precision):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=2, sample_intvs=48)))
    cfg.precision = DotDict(precision)
    params = jmn.init_matchnerf(jax.random.PRNGKey(0), cfg)
    model = MatchNeRF(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    d = ge._synthetic_inputs(cfg, 1, H, W, R=16)
    batch = {"images": d["images"], "extrinsics": d["poses"],
             "intrinsics": d["intr"], "near_fars": d["near_fars"]}
    return cfg, params, model, batch


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


# configs/test.yaml's precision as shipped (the block route), f32 encoder
SHIPPED = dict(dtu_eval_config().precision, encoder_compute_dtype="float32")
JAX_DIRECT = {"encoder_compute_dtype": "float32", "color_sample_dtype": "uint8",
              "banded_kernel": False, "block_kernel": False, "decoder_kernel": False}


@pytest.mark.parametrize("case,dtype,fused,routes", [
    ("int4_block", "int4", False, ("B", "B")),
    ("int4_int8_block", ["int4", "int8"], False, ("B", "D")),
    ("int4p_block", "int4p99.9", False, ("B", "B")),
    ("int8_int4_fused", ["int8", "int4"], True, ("F", "B"))])
def test_render_matches_jax_direct(case, dtype, fused, routes, monkeypatch):
    cfg, params, model, batch = _setup(dict(SHIPPED, cond_sample_dtype=dtype,
                                            fused_cosine=fused))
    taken = []
    for name, key in (("cosine_prior", "B"), ("block_cosine_prior", "D"),
                      ("fused_interp_grouped_cosine", "F")):
        real = getattr(pmn, name)
        monkeypatch.setattr(pmn, name, lambda *a, _k=key, _f=real: taken.append(
            (_k, a[0].dtype)) or _f(*a))
    out = Renderer(cfg, model, "cpu").forward(batch, mode="test")
    # one call per scale and slice (32x32 in 512-ray slices), in scale order
    n_slices = H * W // int(cfg.nerf.rand_rays_test)
    assert [k for k, _ in taken] == list(routes) * n_slices, taken
    per_scale = dtype if isinstance(dtype, list) else [dtype] * 2
    for (k, dt), want in zip(taken, per_scale * n_slices):
        assert (dt == torch.uint8) == pmn.is_int4(want), (k, dt, want)
    jcfg = DotDict(dict(cfg))
    jcfg.precision = DotDict(dict(JAX_DIRECT, cond_sample_dtype=dtype))
    ref = JaxRenderer(jcfg).forward(params, batch, mode="test")
    for k in ("rgb", "depth", "opacity"):
        assert tuple(out[k].shape) == ref[k].shape
        assert torch.isfinite(out[k]).all()
    psnr = _psnr(out["rgb"].numpy(), ref["rgb"])
    assert psnr >= 60.0, f"{case}: agreement PSNR {psnr:.1f} dB < 60"
    assert float(ref["opacity"].max()) > 0.01
