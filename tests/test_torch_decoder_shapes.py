"""The decoder at every shape the JAX Pallas decoder takes (Kernel Cg's
decoders), on the CPU in f32: the port's `cond_nerf_decode` (its plain
version on CPU tensors) against the JAX Pallas `cond_nerf_decode(
fold_composite=True)` in interpret mode and against JAX `apply_cond_nerf` +
`composite`.

- decoders: the NeRF MLP (256x8, skip [4], L_view 4), 64x4 with skip [2],
  64x7 with skips [2, 5], and the shipped shape with raytrans_act GELU; at
  S = 16 and S = 200; the bf16 route against JAX matmul_dtype=bfloat16.
  Tolerances are tests/test_torch_decoder.py's: rgb and opacity atol 3e-5,
  depth atol 3e-4.
- GELU is jax.nn.gelu's tanh form (`test_gelu_decoder_matches_jax`, rgb and
  opacity atol 2e-6, depth 5e-6; the erf form differs by 2.25e-5 / 3.34e-5).
- `legacy_coord: false` against the JAX XLA decoder only: the JAX kernel
  encodes with the legacy encoding whatever the key says (recorded by
  `test_jax_kernel_ignores_legacy_coord`).
- `decoder_route`: C for the shipped decoder, Cg for the others, a
  ValueError naming the limit beyond Cg's.
- Kernel Cg's packed weights in the layout of `any_plan`, and a torch
  emulation of the kernel's MLP (transposed tiles, padded rows, the
  encoding's index arithmetic, the epilogues) on those buffers against the
  plain decoder's tokens and colours.
- the eval entry (`--config test --cpu`, 1 transformer layer, S = 8, a
  64x32 DTU tree) with the NeRF MLP decoder against the JAX Coach >= 60 dB.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder import _setup
from test_torch_eval_entry import _psnr, _run_both, trees  # noqa: F401

import __graft_entry__ as ge
from matchnerf_tpu.models.decoder.cond_nerf import apply_cond_nerf as jax_apply
from matchnerf_tpu.models.decoder.cond_nerf import composite as jax_composite
from matchnerf_tpu.ops.pallas_decoder import cond_nerf_decode as jax_decode
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch.models.decoder import cond_nerf as tcn
from matchnerf_tpu_torch.ops import decoder as tdec
from matchnerf_tpu_torch.ops.nn import DECODER_ACTIVATIONS
from torch_threads import one_torch_thread  # noqa: F401

NERF_MLP = {"decoder.net_width": 256, "decoder.net_depth": 8, "decoder.skip": [4],
            "decoder.posenc.L_view": 4}
DECODERS = {
    "nerf_mlp": NERF_MLP,
    "w64_d4_skip2": {"decoder.net_width": 64, "decoder.net_depth": 4, "decoder.skip": [2]},
    "w64_d7_skips_2_5": {"decoder.net_width": 64, "decoder.net_depth": 7,
                         "decoder.skip": [2, 5]},
    "gelu": {"decoder.raytrans_act": "GELU"},
}
TOLS = (3e-5, 3e-4, 3e-5)


def _cfg(keys):
    """The tiny test config (one transformer layer, S = 16) with dotted keys."""
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=16)))
    for sec in ("decoder", "nerf", "encoder"):
        cfg[sec] = DotDict(dict(cfg[sec]))
    cfg.decoder.posenc = DotDict(dict(cfg.decoder.posenc))
    for key, value in keys.items():
        sub = cfg
        *path, last = key.split(".")
        for k in path:
            sub = sub[k]
        sub[last] = value
    return cfg


def _inputs(a, lib):
    conv = jnp.asarray if lib == "jax" else torch.tensor
    t = {k: conv(v) for k, v in a.items()}
    return t, {k: t[k] for k in ("feat_info", "color_info", "mask_info")}


def _port(model, cfg, a, matmul_dtype=torch.float32, setbg=False):
    t, cond = _inputs(a, "torch")
    with torch.no_grad():
        return tdec.cond_nerf_decode(model.nerf_dec, cfg, t["pts"], t["ray_unit"], cond,
                                     t["depth"], t["ray"], setbg_opaque=setbg,
                                     matmul_dtype=matmul_dtype)


def _jax_kernel(params, cfg, a, matmul_dtype=None):
    j, cond = _inputs(a, "jax")
    return jax_decode(params["nerf_dec"], cfg, j["pts"], j["ray_unit"], cond, block_rays=4,
                      matmul_dtype=matmul_dtype, interpret=True, fold_composite=True,
                      depth_samples=j["depth"], ray=j["ray"])


def _jax_xla(params, cfg, a):
    j, cond = _inputs(a, "jax")
    rgb_s, den_s = jax_apply(params["nerf_dec"], cfg, j["pts"], ray_unit=j["ray_unit"],
                             cond_info=cond)
    return jax_composite(cfg, j["ray"], rgb_s, den_s, j["depth"])[:3]


def _close(got, ref, tols=TOLS):
    for g, r, atol in zip(got, ref, tols):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol, rtol=1e-4)


@pytest.mark.parametrize("S", [16, 200])
@pytest.mark.parametrize("name", list(DECODERS))
def test_plain_decoder_matches_jax(name, S):
    """The port's decoder (plain on CPU tensors) against the JAX kernel in
    interpret mode and the JAX XLA decoder + composite."""
    cfg = _cfg(DECODERS[name])
    params, model, a = _setup(cfg, R=5 if S == 200 else 11, S=S, seed=S + len(name))
    got = _port(model, cfg, a)
    _close(got, _jax_kernel(params, cfg, a))
    _close(got, _jax_xla(params, cfg, a))


# The bf16 route at width 256: a layer's 256-term f32 sums, taken in another
# order than XLA's, now and then land on the other side of a bf16 rounding
# boundary of the next layer's input, and one such flip (2^-8 relative in one
# activation) moves an output by up to ~1e-4 (measured 6.4e-5 rgb and 1.24e-4
# depth at seed 7, where the f32 function is 9.4e-3 / 6.0e-2 away): Kernel C's
# on-card f32 tolerances. The narrower decoders hold the f32 tolerances.
TOLS_BF16 = {"nerf_mlp": (1e-4, 1e-3, 1e-4), "w64_d7_skips_2_5": TOLS}


@pytest.mark.parametrize("name", list(TOLS_BF16))
def test_plain_decoder_bf16_matches_jax(name):
    """The bf16 route's plain twin against the JAX kernel with
    matmul_dtype=bfloat16 (TOLS_BF16); the f32 function differs from it by
    more than ten times a tolerance, so the test tells them apart."""
    cfg = _cfg(DECODERS[name])
    params, model, a = _setup(cfg, S=16, seed=7)
    ref = _jax_kernel(params, cfg, a, jnp.bfloat16)
    _close(_port(model, cfg, a, torch.bfloat16), ref, TOLS_BF16[name])
    gaps = [float(np.abs(g.numpy() - np.asarray(r)).max()) for g, r in
            zip(_port(model, cfg, a), ref)]
    assert max(g / t for g, t in zip(gaps, TOLS_BF16[name])) > 10.0, f"f32 vs bf16 only {gaps}"


def test_gelu_decoder_matches_jax():
    """raytrans_act GELU is jax.nn.gelu's tanh form in the decoder (module
    and apply_cond_nerf): the port against JAX apply_cond_nerf + composite
    at rgb / opacity atol 2e-6 and depth 5e-6 (the erf form measured
    2.25e-5 / 3.34e-5 here); the encoder's GELU stays the erf form."""
    cfg = _cfg(DECODERS["gelu"])
    params, model, a = _setup(cfg, seed=3)
    _close(_port(model, cfg, a), _jax_xla(params, cfg, a), (2e-6, 5e-6, 2e-6))
    x = torch.linspace(-6.0, 6.0, 1001)
    np.testing.assert_allclose(DECODER_ACTIVATIONS["GELU"](x).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))), atol=1e-6)
    assert model.nerf_dec.out_alpha_linear[1].fn is DECODER_ACTIVATIONS["GELU"]
    from matchnerf_tpu_torch.ops.nn import ACTIVATIONS
    np.testing.assert_allclose(ACTIVATIONS["GELU"](x).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()),
                                                      approximate=False)), atol=1e-6)


@pytest.mark.parametrize("S", [16, 200])
def test_standard_coordinates_match_jax_xla(S):
    """legacy_coord: false (the pi-scaled interleaved encoding, L_view 4 so
    that the direction is encoded too) against the JAX XLA decoder."""
    cfg = _cfg(dict(NERF_MLP, **{"nerf.legacy_coord": False}))
    params, model, a = _setup(cfg, R=5, S=S, seed=11)
    _close(_port(model, cfg, a), _jax_xla(params, cfg, a))


def test_jax_kernel_ignores_legacy_coord():
    """A fault of the JAX package, recorded: its Pallas decoder reads
    `legacy` (pallas_decoder.py:111) and always encodes with the legacy
    encoding (:280-283), so with legacy_coord: false it departs from its
    own XLA decoder (models/decoder/cond_nerf.py:80-81) by more than 0.1 in
    rgb (measured here: 0.320 rgb, 0.112 depth after the composite)."""
    cfg = _cfg({"nerf.legacy_coord": False})
    params, _, a = _setup(cfg, seed=2)
    gap = float(np.abs(np.asarray(_jax_kernel(params, cfg, a)[0])
                       - np.asarray(_jax_xla(params, cfg, a)[0])).max())
    assert gap > 0.1, gap


def test_decoder_route_and_limits():
    """C for the shipped decoder, Cg for each other decoder; beyond Cg's
    limits a ValueError that names the limit; none for view_dep: false."""
    _, model, _ = _setup(_cfg({}))
    assert tdec.decoder_route(model.nerf_dec, _cfg({}), 128) == "C"
    for keys in [*DECODERS.values(), {"nerf.legacy_coord": False},
                 {"encoder.cos_n_group": [30, 30]}]:
        cfg = _cfg(keys)
        _, model, _ = _setup(cfg)
        assert tdec.decoder_route(model.nerf_dec, cfg, 128) == "Cg", keys
        assert tdec.decoder_route(model.nerf_dec, cfg, 512) == "Cg", keys
    cases = [({"decoder.net_width": 514}, 16, "even net_width from 32 to 512"),
             ({"decoder.net_width": 66}, 513, "S <= 512"),
             ({}, 513, "S <= 512"),
             ({"encoder.cos_n_group": [60, 60]}, 16, r"Gf \+ 4V <= 128 \(Gf \+ 4V = 132\)"),
             ({"decoder.net_depth": 17, "decoder.skip": [4]}, 16, "net_depth 1 to 16"),
             ({"decoder.net_depth": 5, "decoder.skip": [4]}, 16, "no skip after the last"),
             ({"decoder.posenc.L_3D": 11}, 16, "L_3D and L_view 0 to 10")]
    for keys, S, match in cases:
        cfg = _cfg(keys)
        with pytest.raises(ValueError, match=match):
            tdec.decoder_route(tcn.CondNeRF(cfg), cfg, S)
    cfg = _cfg({"nerf.view_dep": False})
    with pytest.raises(ValueError, match="view_dep"):
        tdec.decoder_route(tcn.CondNeRF(cfg), cfg, 16)


def test_cg_weight_pack_layout():
    """Kernel Cg's buffers: `_tail` then the biases from SM_BIAS in the
    small buffer; each wide layer a row-major [K, np] block at its offset
    with its parts' rows at their padded starts, zero elsewhere; the bf16
    route's weights rounded to bf16, its biases f32."""
    cfg = _cfg(DECODERS["w64_d7_skips_2_5"])
    _, model, _ = _setup(cfg, seed=4)
    dec = model.nerf_dec
    W, D, skips, E, Ev, CD = tdec.decoder_shape(dec)
    assert (W, D, skips, E, Ev, CD) == (64, 7, (3, 6), 63, 3, 22)
    layers, n_wts, n_small = tdec.any_plan(W, D, skips, E, Ev, CD)
    assert [l["name"] for l in layers] == (["pts_bias"] + [f"pts_linears.{i}" for i in range(7)]
                                           + ["alpha_linear.0", "feature_linear",
                                              "views_linears.0", "rgb_linear"])
    assert [l["parts"] for l in layers[1:5]] == [
        [("enc", 64, 63)], [("h", 64, 64)], [("h", 64, 64)], [("enc", 64, 63), ("h", 64, 64)]]
    assert [l["np"] for l in layers] == [64] * 8 + [16, 64, 32, 8]
    assert layers[-1]["woff"] + 32 * 8 == n_wts and layers[-1]["boff"] + 8 == n_small
    for md in (torch.float32, torch.bfloat16):
        small, wts = tdec.pack_any(dec, md)
        assert small.numel() == n_small and wts.numel() == n_wts
        torch.testing.assert_close(small[:256].reshape(16, 16),
                                   dec.ray_attention.w_qs.weight.t(), rtol=0, atol=0)
        torch.testing.assert_close(small[1344:1345], dec.out_alpha_linear[2].bias,
                                   rtol=0, atol=0)
        assert not small[1345:tdec.SM_BIAS].any()
        mods = dict(dec.named_modules())
        for lay in layers:
            m = mods[lay["name"]]
            torch.testing.assert_close(small[lay["boff"]:lay["boff"] + m.bias.numel()],
                                       m.bias, rtol=0, atol=0)
            K = sum(p[1] for p in lay["parts"])
            block = wts[lay["woff"]:lay["woff"] + K * lay["np"]].reshape(K, lay["np"])
            w = m.weight.t()
            if md == torch.bfloat16:
                w = w.to(torch.bfloat16).float()
            want = torch.zeros_like(block)
            src = dst = 0
            for _, padded, real in lay["parts"]:
                want[dst:dst + real, :w.shape[1]] = w[src:src + real]
                src, dst = src + real, dst + padded
            assert torch.equal(block, want), lay["name"]
    skip_layer, wts = layers[4], tdec.pack_any(dec, torch.float32)[1]
    block = wts[skip_layer["woff"]:skip_layer["woff"] + 128 * 64].reshape(128, 64)
    w = dec.pts_linears[3].weight.t()
    assert torch.equal(block[:63], w[:63]) and not block[63].any()
    assert torch.equal(block[64:], w[63:])


def _encode_rows(x, L, legacy, rows):
    """The kernel's `encode`: row j of [x, posenc(x)] for every j < rows,
    from its index arithmetic (zero past 3 + 6L) -> [rows, n]."""
    out = torch.zeros(rows, x.shape[0])
    for j in range(rows):
        if j < 3:
            out[j] = x[:, j]
            continue
        i = j - 3
        if i >= 6 * L:
            continue
        if legacy:
            s, r = divmod(i, 3 * L)
            l, c = divmod(r, 3)
            f = torch.tensor(float(1 << l))
        else:
            c, r = divmod(i, 2 * L)
            s, l = divmod(r, L)
            f = torch.tensor(math.pi, dtype=torch.float32) * float(1 << l)
        v = x[:, c] * f
        out[j] = torch.sin(v) if s == 0 else torch.cos(v)
    return out


def _emulate_mlp(dec, cfg, a, md):
    """Kernel Cg's MLP on its packed buffers, as the kernel computes it on a
    tile: transposed activations [rows, samples] with the padded rows, the
    layers of `any_plan` in order, the epilogues; returns the token (after
    the activation) and rgb of every sample."""
    small, wts = tdec.pack_any(dec, md)
    W, D, skips, E, Ev, CD = tdec.decoder_shape(dec)
    layers, _, _ = tdec.any_plan(W, D, skips, E, Ev, CD)
    L3, Lv = tdec._posenc_freqs(cfg)
    st = (lambda v: v.to(torch.bfloat16).float()) if md == torch.bfloat16 else (lambda v: v)
    n = a["pts"].reshape(-1, 3).shape[0]
    cond = torch.cat([torch.tensor(a[k]).reshape(n, -1)
                      for k in ("feat_info", "color_info", "mask_info")], dim=1)
    bufs = {"cond": st(torch.cat([cond.t(), torch.zeros(-(-CD // 8) * 8 - CD, n)])),
            "enc": st(_encode_rows(torch.tensor(a["pts"]).reshape(n, 3), L3,
                                   cfg.nerf.legacy_coord, -(-E // 8) * 8)),
            "dir": st(_encode_rows(torch.tensor(a["ray_unit"]).reshape(n, 3), Lv,
                                   cfg.nerf.legacy_coord, -(-Ev // 8) * 8))}
    act = DECODER_ACTIVATIONS[tcn.raytrans_act_name(cfg)]
    for lay in layers:
        x = torch.cat([bufs[p[0]][:p[1]] for p in lay["parts"]])
        K = x.shape[0]
        w = wts[lay["woff"]:lay["woff"] + K * lay["np"]].reshape(K, lay["np"])
        y = (w.t().double() @ x.double()).float() + small[lay["boff"]:lay["boff"]
                                                          + lay["np"]][:, None]
        name = lay["name"]
        if name == "pts_bias":
            bufs["bias"] = y
        elif name.startswith("pts_linears"):
            bufs["h"] = st(torch.relu(y * bufs["bias"]))
        elif name == "alpha_linear.0":
            tok = act(y).t()
        elif name == "feature_linear":
            bufs["h"] = st(y)
        elif name == "views_linears.0":
            bufs["h"] = st(torch.relu(y))
        else:
            rgb = torch.sigmoid(y[:3]).t()
    return tok, rgb


@pytest.mark.parametrize("md", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("keys", [NERF_MLP, dict(NERF_MLP, **{"nerf.legacy_coord": False}),
                                  DECODERS["w64_d7_skips_2_5"]],
                         ids=["nerf_mlp", "nerf_mlp_standard", "skips_2_5"])
def test_cg_emulation_matches_plain(keys, md):
    """The kernel's MLP emulated on its packed buffers gives the plain
    decoder's tokens (alpha_linear after the activation, before the
    sinusoid table) and per-sample rgb on both routes."""
    cfg = _cfg(keys)
    _, model, a = _setup(cfg, R=6, S=16, seed=8)
    dec = model.nerf_dec
    tok, rgb = _emulate_mlp(dec, cfg, a, md)
    seen = {}
    wide = tcn._wide_linear

    def recording(matmul_dtype):
        lin = wide(matmul_dtype)

        def rec(m, x):
            y = lin(m, x)
            if m is dec.alpha_linear[0]:
                seen["out"] = y
            return y
        return rec
    t, cond = _inputs(a, "torch")
    tcn._wide_linear = recording
    try:
        with torch.no_grad():
            rgb_ref, _ = tcn.apply_cond_nerf(dec, cfg, t["pts"], t["ray_unit"], cond,
                                             matmul_dtype=md)
    finally:
        tcn._wide_linear = wide
    tok_ref = DECODER_ACTIVATIONS[tcn.raytrans_act_name(cfg)](seen["out"]).reshape(-1, 16)
    tol = 1e-5 if md == torch.float32 else 2e-2
    torch.testing.assert_close(tok, tok_ref, atol=tol, rtol=1e-4)
    torch.testing.assert_close(rgb, rgb_ref.reshape(-1, 3), atol=tol, rtol=1e-4)


def test_eval_entry_nerf_mlp_matches_jax(tmp_path, trees):  # noqa: F811
    """`python -m matchnerf_tpu_torch.test --config test --cpu` with the NeRF
    MLP decoder (256x8, L_view 4) on a 64x32 DTU tree, 1 transformer layer,
    S = 8, seeded JAX weights passed across: the image >= 60 dB against the
    JAX Coach's (its Pallas decoder in interpret mode), metrics to 1e-4."""
    over = {"decoder.net_width": 256, "decoder.net_depth": 8, "decoder.posenc.L_view": 4}
    got, want, renders = _run_both(tmp_path, trees, "test", ("dtu",), **over)
    (port, _, _), (ref, _) = renders["port"][0], renders["jax"][0]
    psnr = _psnr(port, ref)
    assert psnr >= 60.0, f"agreement PSNR {psnr:.1f} dB < 60"
    for k, v in want["dtu"].items():
        np.testing.assert_allclose(got["dtu"][k], v, atol=1e-4, err_msg=k)
