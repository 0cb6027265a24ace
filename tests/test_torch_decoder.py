"""Kernel C (CondNeRF decoder + composite) of the PyTorch port vs the JAX
package, on the CPU in f32.

The port's `cond_nerf_decode` (plain version on CPU tensors) is held
against the JAX Pallas `cond_nerf_decode(fold_composite=True)` in interpret
mode and against JAX `apply_cond_nerf` + `composite`, for the flagship
decoder and for the configs/demo_own.yaml variants (ELU, density maskfill,
ray-transformer posenc), with and without render intervals and the opaque
background. Tolerances are those tests/test_pallas_decoder.py uses for the
folded kernel: rgb and opacity atol 3e-5, depth atol 3e-4 (depth ~4).
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
    """pack_weights puts every linear as [in,out] then bias, in kernel order."""
    cfg, _ = _cfg("flagship")
    _, model, _ = _setup(cfg)
    dec = model.nerf_dec
    w = tdec.pack_weights(dec)
    CD = dec.pts_bias.in_features
    n_expected = (CD * 128 + 128 + 63 * 128 + 4 * 128 * 128 + 191 * 128 + 6 * 128
                  + 128 * 16 + 16 + 4 * 256 + 32 + 256 + 16 + 16 + 1
                  + 128 * 128 + 128 + 131 * 64 + 64 + 64 * 3 + 3)
    assert w.numel() == n_expected
    torch.testing.assert_close(w[:CD * 128].reshape(CD, 128), dec.pts_bias.weight.t())
    torch.testing.assert_close(w[-3:], dec.rgb_linear.bias)
