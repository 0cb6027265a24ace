"""Kernel C (CondNeRF decoder + composite) of the PyTorch port vs the JAX
package, on the CPU in f32.

The port's `cond_nerf_decode` (plain version on CPU tensors) is held
against the JAX Pallas `cond_nerf_decode(fold_composite=True)` in interpret
mode and against JAX `apply_cond_nerf` + `composite`, for the flagship
decoder and for the configs/demo_own.yaml variants (ELU, density maskfill,
ray-transformer posenc), with and without render intervals and the opaque
background, at S = 16 and at S = 200 (two of the kernel's 128-sample
tiles); the bf16 route's plain twin against the JAX kernel with
matmul_dtype=bfloat16. Tolerances are those tests/test_pallas_decoder.py
uses for the folded kernel: rgb and opacity atol 3e-5, depth atol 3e-4
(depth ~4). Also the layout of the kernel's packed weights (split TF32 and
bf16 fragments), their cache, and the kernel's sample limit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.models.decoder.cond_nerf import apply_cond_nerf as jax_apply
from matchnerf_tpu.models.decoder.cond_nerf import composite as jax_composite
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.ops.pallas_decoder import cond_nerf_decode as jax_decode
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch.models.decoder import cond_nerf as tcn
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF
from matchnerf_tpu_torch.ops import decoder as tdec
from matchnerf_tpu_torch.weights import state_dict_from_jax

VARIANTS = {
    "flagship": {},
    "demo_own": {"decoder": {"raytrans_act": "ELU", "density_maskfill": True,
                             "raytrans_posenc": True}},
    "intervals_bg": {"nerf": {"wo_render_interval": False},
                     "decoder": {"density_maskfill": True}, "setbg": True},
}


def _cfg(variant):
    cfg = ge._tiny_cfg(n_layers=1, sample_intvs=16)
    cfg = DotDict(dict(cfg))
    over = VARIANTS[variant]
    for sec in ("decoder", "nerf"):
        if sec in over:
            d = DotDict(dict(cfg[sec]))
            d.update(over[sec])
            cfg[sec] = d
    return cfg, bool(over.get("setbg", False))


def _setup(cfg, B=1, R=11, S=16, seed=0):
    rng = np.random.default_rng(seed)
    params = jax_init(jax.random.PRNGKey(seed), cfg)
    # non-zero biases so every bias path is exercised
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jnp.asarray(rng.normal(size=x.shape), x.dtype)
        if x.ndim == 1 else x, params)
    model = MatchNeRF(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    V = cfg.n_src_views
    Gf = int(sum(cfg.encoder.cos_n_group))
    ray = rng.normal(0, 1, (B, R, 3)).astype(np.float32)
    unit = ray / np.linalg.norm(ray, axis=-1, keepdims=True)
    mask = rng.integers(0, 2, (B, R, S, V)).astype(np.float32)
    mask[:, :2] = 0.0                         # rays seen by no view (maskfill)
    mask[:, 2:4] = np.eye(3, dtype=np.float32)[0]   # one view: masked queries
    arrays = {
        "pts": rng.uniform(-1, 1, (B, R, S, 3)).astype(np.float32),
        "ray_unit": np.ascontiguousarray(np.broadcast_to(unit[:, :, None], (B, R, S, 3))),
        "feat_info": rng.uniform(-1, 1, (B, R, S, Gf)).astype(np.float32),
        "color_info": rng.uniform(0, 1, (B, R, S, 3 * V)).astype(np.float32),
        "mask_info": mask,
        "depth": np.sort(rng.uniform(2.0, 4.5, (B, R, S)), axis=-1)[..., None].astype(np.float32),
        "ray": ray,
    }
    return params, model, arrays


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_kernel_c_matches_jax(variant):
    cfg, setbg = _cfg(variant)
    params, model, a = _setup(cfg, seed=len(variant))
    j = {k: jnp.asarray(v) for k, v in a.items()}
    jcond = {k: j[k] for k in ("feat_info", "color_info", "mask_info")}
    ref_kernel = jax_decode(params["nerf_dec"], cfg, j["pts"], j["ray_unit"], jcond,
                            block_rays=4, fold_composite=True,
                            depth_samples=j["depth"], ray=j["ray"], setbg_opaque=setbg)
    rgb_s, den_s = jax_apply(params["nerf_dec"], cfg, j["pts"], ray_unit=j["ray_unit"],
                             cond_info=jcond)
    ref_xla = jax_composite(cfg, j["ray"], rgb_s, den_s, j["depth"], setbg_opaque=setbg)[:3]

    t = {k: torch.tensor(v) for k, v in a.items()}
    tcond = {k: t[k] for k in ("feat_info", "color_info", "mask_info")}
    before = tdec.COUNTER.launches
    with torch.no_grad():
        got = tdec.cond_nerf_decode(model.nerf_dec, cfg, t["pts"], t["ray_unit"], tcond,
                                    t["depth"], t["ray"], setbg_opaque=setbg)
    assert tdec.COUNTER.launches == before      # CPU tensors take the plain version
    for ref in (ref_kernel, ref_xla):
        for g, r, atol in zip(got, ref, (3e-5, 3e-4, 3e-5)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol, rtol=1e-4)


def test_apply_cond_nerf_per_sample_matches_jax():
    """The decoder before the composite, per sample (B=2, ragged R)."""
    cfg, _ = _cfg("demo_own")
    params, model, a = _setup(cfg, B=2, R=7, seed=9)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    jcond = {k: j[k] for k in ("feat_info", "color_info", "mask_info")}
    rgb_j, den_j = jax_apply(params["nerf_dec"], cfg, j["pts"], ray_unit=j["ray_unit"],
                             cond_info=jcond)
    t = {k: torch.tensor(v) for k, v in a.items()}
    with torch.no_grad():
        rgb_t, den_t = tcn.apply_cond_nerf(model.nerf_dec, cfg, t["pts"], t["ray_unit"],
                                           {k: t[k] for k in jcond})
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(den_t.numpy(), np.asarray(den_j), atol=2e-4, rtol=1e-4)


def test_kernel_weight_pack_layout():
    """pack_small puts the biases and the 16-wide layers in the order of the
    .cu file's SM_* offsets; the wide layers stream in kernel order with
    their padded shapes, and each route's fragment buffer has the size the
    launcher's group table expects."""
    cfg, _ = _cfg("flagship")
    _, model, _ = _setup(cfg)
    dec = model.nerf_dec
    small = tdec.pack_small(dec)
    assert small.numel() == 2465
    ra = dec.ray_attention
    torch.testing.assert_close(small[0:128], dec.pts_bias.bias, rtol=0, atol=0)
    torch.testing.assert_close(small[128 + 128 * 5:128 + 128 * 6], dec.pts_linears[5].bias,
                               rtol=0, atol=0)
    torch.testing.assert_close(small[1104:1107], dec.rgb_linear.bias, rtol=0, atol=0)
    assert not small[1107:1120].any()
    torch.testing.assert_close(small[1120:1376].reshape(16, 16), ra.w_qs.weight.t(),
                               rtol=0, atol=0)
    torch.testing.assert_close(small[2176:2432].reshape(16, 16),
                               dec.out_alpha_linear[0].weight.t(), rtol=0, atol=0)
    torch.testing.assert_close(small[-1:], dec.out_alpha_linear[2].bias, rtol=0, atol=0)
    shapes = [tuple(w.shape) for w in tdec.wide_layers(dec)]
    cdp = -(-dec.pts_bias.in_features // 16) * 16
    assert shapes == [(cdp, 128), (64, 128), *[(128, 128)] * 4, (192, 128), (128, 16),
                      (128, 128), (144, 64), (64, 16)]
    # the launcher's count: K*N/2 16-byte units in split TF32, K*N/8 in bf16
    kn = sum(k * n for k, n in shapes)
    assert tdec.pack_fragments(dec, torch.float32).numel() == 16 * kn // 2
    assert tdec.pack_fragments(dec, torch.bfloat16).numel() == 16 * kn // 8


def _unpack(frag, K, N, dtype):
    """Inverse of ops.decoder.fragments: the padded [K, N] matrix (split
    TF32: hi and lo)."""
    if dtype == torch.float32:
        f = frag.view(torch.float32).reshape(K // 8, N // 8, 8, 4, 4)   # j, nt, g, t, (hi|lo, i)
        out = []
        for part in (f[..., 0:2], f[..., 2:4]):
            out.append(part.permute(0, 3, 4, 1, 2).reshape(K, N))       # j, t, i, nt, g
        return out
    f = frag.view(torch.bfloat16).reshape(K // 16, N // 16, 8, 4, 2, 2, 2)  # kb, p, g, t, u, r, i
    return [f.permute(0, 5, 3, 6, 1, 4, 2).reshape(K, N)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_fragment_layout(dtype):
    """Each wide layer's fragments hold the layer's weight at the documented
    places: split TF32 hi + lo rebuilds the f32 weight exactly (hi has no
    bits below TF32), the bf16 pack equals the rounded weight, the padded
    rows and columns are zero, and the skip layer's h rows start at 64."""
    cfg, _ = _cfg("demo_own")
    _, model, _ = _setup(cfg, seed=4)
    dec = model.nerf_dec
    mats = tdec.wide_layers(dec)
    frag = tdec.pack_fragments(dec, dtype)
    pos = 0
    for w in mats:
        K, N = w.shape
        size = K * N * (8 if dtype == torch.float32 else 2)
        got = _unpack(frag[pos:pos + size], K, N, dtype)
        pos += size
        if dtype == torch.float32:
            hi, lo = got
            assert torch.equal(hi + lo, w)
            assert not (hi.view(torch.int32) & 0x1FFF).any()
            assert float((hi - w).abs().max()) <= 2.0 ** -11 * float(w.abs().max())
        else:
            assert torch.equal(got[0], w.to(torch.bfloat16))
    assert pos == frag.numel()
    skip = dec.pts_linears[5].weight.t()
    torch.testing.assert_close(mats[6][:63], skip[:63], rtol=0, atol=0)
    assert not mats[6][63].any()
    torch.testing.assert_close(mats[6][64:], skip[63:], rtol=0, atol=0)
    assert not mats[1][63].any() and not mats[9][131:].any() and not mats[10][:, 3:].any()
    torch.testing.assert_close(mats[9][:131], dec.views_linears[0].weight.t(), rtol=0, atol=0)
    cd = dec.pts_bias.in_features
    assert not mats[0][cd:].any()


def test_kernel_weights_cache_follows_updates():
    """The wrapper packs a module's weights once per route and device, and a
    weight update (in place, as an optimizer step does) reaches the next
    call."""
    cfg, _ = _cfg("flagship")
    _, model, _ = _setup(cfg)
    dec = model.nerf_dec
    small, frag = tdec.kernel_weights(dec, torch.float32, "cpu")
    again = tdec.kernel_weights(dec, torch.float32, "cpu")
    assert again[0] is small and again[1] is frag
    bf = tdec.kernel_weights(dec, torch.bfloat16, "cpu")
    assert bf[1].numel() == frag.numel() // 4
    with torch.no_grad():
        dec.pts_linears[2].bias.add_(1.0)
        dec.feature_linear.weight.mul_(2.0)
    small2, frag2 = tdec.kernel_weights(dec, torch.float32, "cpu")
    assert small2 is not small and frag2 is not frag
    torch.testing.assert_close(small2[128 + 256:128 + 384], dec.pts_linears[2].bias,
                               rtol=0, atol=0)
    assert torch.equal(frag2, tdec.pack_fragments(dec, torch.float32))
    assert not torch.equal(frag2, frag)
    assert tdec.kernel_weights(dec, torch.float32, "cpu")[1] is frag2
    assert tdec.kernel_weights(dec, torch.bfloat16, "cpu")[1] is not bf[1]
    tab = tdec.postab_table(200, "cpu")
    assert tdec.postab_table(200, "cpu") is tab and tuple(tab.shape) == (200, 16)


def test_kernel_sample_limit():
    """The kernel takes up to S_MAX = 512 samples per ray; above it the
    wrapper's check raises and names the limit (on the CPU the plain
    version has no limit)."""
    cfg, _ = _cfg("flagship")
    _, model, _ = _setup(cfg)
    assert tdec.S_MAX == 512
    tdec._check_supported(model.nerf_dec, cfg, 512)
    with pytest.raises(ValueError, match="S <= 512"):
        tdec._check_supported(model.nerf_dec, cfg, 513)


def _decode_both(variant, S, seed, jax_dtype, torch_dtype):
    cfg, setbg = _cfg(variant)
    params, model, a = _setup(cfg, S=S, seed=seed)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    jcond = {k: j[k] for k in ("feat_info", "color_info", "mask_info")}
    ref = jax_decode(params["nerf_dec"], cfg, j["pts"], j["ray_unit"], jcond,
                     block_rays=4, matmul_dtype=jax_dtype, interpret=True,
                     fold_composite=True, depth_samples=j["depth"], ray=j["ray"],
                     setbg_opaque=setbg)
    t = {k: torch.tensor(v) for k, v in a.items()}
    tcond = {k: t[k] for k in ("feat_info", "color_info", "mask_info")}
    with torch.no_grad():
        got = tdec.cond_nerf_decode(model.nerf_dec, cfg, t["pts"], t["ray_unit"], tcond,
                                    t["depth"], t["ray"], setbg_opaque=setbg,
                                    matmul_dtype=torch_dtype)
        f32 = tdec.cond_nerf_decode(model.nerf_dec, cfg, t["pts"], t["ray_unit"], tcond,
                                    t["depth"], t["ray"], setbg_opaque=setbg)
    return cfg, params, j, jcond, setbg, ref, got, f32


@pytest.mark.parametrize("S", [16, 200])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_kernel_c_bf16_matches_jax(variant, S):
    """The bf16 route's plain twin against the JAX Pallas decoder with
    matmul_dtype=bfloat16 (interpret mode) at the f32 tolerances; the f32
    function differs from it by more than ten times the tolerance of one of
    rgb, depth and opacity (measured 7.9e-4 to 3.8e-3 in rgb, 26 to 127
    times its tolerance), so the test tells the two apart."""
    _, _, _, _, _, ref, got, f32 = _decode_both(variant, S, 3, jnp.bfloat16, torch.bfloat16)
    for g, r, atol in zip(got, ref, (3e-5, 3e-4, 3e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol, rtol=1e-4)
    tols = (3e-5, 3e-4, 3e-5)
    gaps = [float(np.abs(f.numpy() - np.asarray(r)).max()) for f, r in zip(f32, ref)]
    assert max(g / t for g, t in zip(gaps, tols)) > 10.0, f"f32 vs bf16 only {gaps}"


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_kernel_c_matches_jax_long_rays(variant):
    """The f32 route at S = 200 (two of the kernel's 128-sample tiles)
    against the JAX Pallas decoder and the JAX XLA decoder + composite."""
    cfg, params, j, jcond, setbg, ref, got, _ = _decode_both(variant, 200, 5, None,
                                                             torch.float32)
    rgb_s, den_s = jax_apply(params["nerf_dec"], cfg, j["pts"], ray_unit=j["ray_unit"],
                             cond_info=jcond)
    ref_xla = jax_composite(cfg, j["ray"], rgb_s, den_s, j["depth"], setbg_opaque=setbg)[:3]
    for r_all in (ref, ref_xla):
        for g, r, atol in zip(got, r_all, (3e-5, 3e-4, 3e-5)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol, rtol=1e-4)
