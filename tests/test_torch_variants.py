"""The model variants that config keys reach, the port against the JAX
package on the CPU:

- `nerf.view_dep: false`: the CondNeRF with one `output_linear` (W -> 4)
  through the weight bridge, its outputs atol 1e-5; the port's state_dict
  read back by the JAX importer (`import_torch.import_cond_nerf_params`).
- `encoder.feature_sample_local_radius` r = 1 and 2 at dilation 1 and 2:
  `sample_features_by_grid` atol 1e-5 (the port sums the window one offset
  at a time, JAX takes the mean of the stacked window).
- `encoder.attn_splits_list: [1]`: `full_attention` atol 1e-5 in f32 and
  one bf16 step (2**-8 relative, the output's rounding) in bf16; the
  encoder at [1] in f32 within 2e-5 of each scale's largest magnitude (as
  tests/test_torch_encoder.py) and in bf16 within 5e-2 of it (the two
  frameworks round the convolutions' and products' outputs to bf16 at
  other places).
- Kernel F's plain twin against JAX `fused_interp_grouped_cosine` (Pallas,
  interpret mode, rows without scales) at V = 2 and 4: atol 1e-5.
- `camera.get_novel_view_poses`: atol 1e-6.
- `utils.profiling`: `Stopwatch.report` equals the JAX one on the same
  totals, `trace` writes a Chrome trace naming an annotated range, and the
  training entry's `profile_trace_dir` writes one.
- Whole images (`Renderer.forward`, 32x32, the tiny two-layer model at
  configs/test.yaml's precision with the f32 encoder; the port's kernels'
  plain versions here) >= 60 dB against the JAX render for each variant:
  `view_dep: false`, the local radius (r = 1, dilation 2), attention
  without splits, and `precision.fused_cosine` at V = 2 and 4 (held to the
  JAX UNFUSED route on int8 tables: the JAX fused route drops the int8
  scales, tests/test_torch_fused_cosine.py).
- One train.yaml step (f32 policy) with `view_dep: false` and one with the
  local radius, and one train_fast.yaml step with `view_dep: false`: the
  loss and every gradient against JAX `make_train_step` at
  tests/test_torch_train_step.py's tolerances.
"""
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_loop import _coach, _tiny_train_cfg
from test_torch_train_step import run_parity

import __graft_entry__ as ge
from matchnerf_tpu import camera as jcam
from matchnerf_tpu.import_torch import import_cond_nerf_params
from matchnerf_tpu.models.decoder.cond_nerf import apply_cond_nerf as jax_apply
from matchnerf_tpu.models.gmflow.gmflow import pair_index_lists
from matchnerf_tpu.models.matchnerf import encode as jax_encode
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.ops.attention import full_attention as jax_full_attention
from matchnerf_tpu.ops.grid_sample import sample_features_by_grid as jax_sample
from matchnerf_tpu.ops.pallas_cond import fused_interp_grouped_cosine as jax_fused
from matchnerf_tpu.renderer import Renderer as JaxRenderer
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu.utils.profiling import Stopwatch as JaxStopwatch
from matchnerf_tpu_torch import camera
from matchnerf_tpu_torch.config import dtu_eval_config
from matchnerf_tpu_torch.models.decoder.cond_nerf import apply_cond_nerf
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF, encode
from matchnerf_tpu_torch.ops.attention import full_attention
from matchnerf_tpu_torch.ops.fused_cosine import fused_interp_grouped_cosine_plain
from matchnerf_tpu_torch.ops.grid_sample import sample_features_by_grid
from matchnerf_tpu_torch.renderer import Renderer
from matchnerf_tpu_torch.utils import profiling
from matchnerf_tpu_torch.weights import state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401


def _tame_output(params):
    """Give the view_dep: false decoder's raw outputs the range of the
    view_dep decoder's: its density has no ReLU, and at random weights a
    negative density makes the composite's transmittance exp(-sum) grow to
    ~1e28, where an image PSNR says nothing. The density column of
    `output_linear` is scaled by 0.01 with a bias of 1 (density ~1); the
    rgb columns by 1/4 (the largest slope of the sigmoid that ends the
    view_dep decoder) with their bias moved by 0.5 (its value at 0), so the
    image follows the features as closely as the view_dep image does."""
    out = dict(params["nerf_dec"]["output_linear"])
    out["w"] = out["w"] * jnp.array([0.25, 0.25, 0.25, 0.01], jnp.float32)
    out["b"] = out["b"] * jnp.array([0.25, 0.25, 0.25, 0.0], jnp.float32) \
        + jnp.array([0.5, 0.5, 0.5, 1.0], jnp.float32)
    return {**params, "nerf_dec": {**params["nerf_dec"], "output_linear": out}}


def _model(cfg, key=0):
    params = jax_init(jax.random.PRNGKey(key), cfg)
    if not cfg.nerf.view_dep:
        params = _tame_output(params)
    model = MatchNeRF(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return params, model


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_cond_nerf_without_view_dep_matches_jax(policy):
    """The decoder's raw rgb and density (no sigmoid, no ray attention),
    f32 and under the bf16 decoder policy (width-W layers in bf16, the
    output_linear in f32 as JAX promotes it)."""
    cfg = ge._tiny_cfg(n_layers=1, sample_intvs=16)
    cfg.nerf.view_dep = False
    cfg.precision = DotDict({"decoder_compute_dtype": policy})
    params, model = _model(cfg)
    assert "nerf_dec.output_linear.weight" in model.state_dict()
    assert not any("views_linears" in k or "ray_attention" in k for k in model.state_dict())
    jdec = import_cond_nerf_params({k[len("nerf_dec."):]: v.numpy()
                                    for k, v in model.state_dict().items()
                                    if k.startswith("nerf_dec.")})
    np.testing.assert_array_equal(np.asarray(jdec["output_linear"]["w"]),
                                  np.asarray(params["nerf_dec"]["output_linear"]["w"]))
    rng = np.random.default_rng(3)
    R, S, G, V = 6, 16, 10, 3
    pts = rng.uniform(-1, 1, (1, R, S, 3)).astype(np.float32)
    cond = {"feat_info": rng.uniform(-1, 1, (1, R, S, G)).astype(np.float32),
            "color_info": rng.uniform(0, 1, (1, R, S, 3 * V)).astype(np.float32),
            "mask_info": (rng.uniform(0, 1, (1, R, S, V)) > 0.3).astype(np.float32)}
    jrgb, jden = jax_apply(params["nerf_dec"], cfg, jnp.asarray(pts), None,
                           {k: jnp.asarray(v) for k, v in cond.items()})
    with torch.no_grad():
        rgb, den = apply_cond_nerf(model.nerf_dec, cfg, torch.tensor(pts), None,
                                   {k: torch.tensor(v) for k, v in cond.items()})
    assert rgb.dtype == den.dtype == torch.float32
    # bf16: one bf16 step of the output's range (the two round alike)
    tol = 1e-5 if policy == "float32" else 2.0 ** -8 * float(np.abs(jrgb).max())
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=tol, rtol=0)
    np.testing.assert_allclose(den.numpy(), np.asarray(jden), atol=tol, rtol=0)
    # the check sees the features: feat_info off by 1e-2 fails it
    cond["feat_info"] = cond["feat_info"] + 1e-2
    with torch.no_grad():
        off, _ = apply_cond_nerf(model.nerf_dec, cfg, torch.tensor(pts), None,
                                 {k: torch.tensor(v) for k, v in cond.items()})
    assert float(np.abs(off.numpy() - np.asarray(jrgb)).max()) > tol


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("dilation", [1, 2])
def test_sample_features_by_grid_local_radius(radius, dilation):
    """The window mean with the reference's renormalisation, points on and
    beyond the border included."""
    rng = np.random.default_rng(radius * 10 + dilation)
    feat = rng.normal(0, 1, (2, 9, 13, 8)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 7, 2)).astype(np.float32)
    grid[0, 0, :, 0] = 1.0
    grid[1, 1, :, 1] = -1.0
    want = jax_sample(jnp.asarray(feat), jnp.asarray(grid), local_radius=radius,
                      local_dilation=dilation)
    got = sample_features_by_grid(torch.tensor(feat), torch.tensor(grid), radius, dilation)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    plain = sample_features_by_grid(torch.tensor(feat), torch.tensor(grid), 0, dilation)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jax_sample(
        jnp.asarray(feat), jnp.asarray(grid))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_attention_matches_jax(dtype):
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(0, 1, (3, 40, 32)).astype(np.float32) for _ in range(3))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax_full_attention(*(jnp.asarray(x, jd) for x in (q, k, v)))
    got = full_attention(*(torch.tensor(x).to(td) for x in (q, k, v)))
    assert got.dtype == td
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("policy,tol", [("float32", 2e-5), ("bfloat16", 5e-2)])
def test_encoder_without_splits_matches_jax(policy, tol):
    """`attn_splits_list: [1]`: the position embedding over the whole map,
    attention over all its tokens, no shift mask."""
    cfg = ge._tiny_cfg(n_layers=2, sample_intvs=16)
    cfg.encoder.attn_splits_list = [1]
    cfg.precision = DotDict({"encoder_compute_dtype": policy})
    params, model = _model(cfg)
    imgs = np.random.default_rng(0).uniform(0, 1, (1, 3, 32, 64, 3)).astype(np.float32)
    ref = jax_encode(params, cfg, jnp.asarray(imgs))
    with torch.no_grad():
        got = encode(model, cfg, torch.tensor(imgs))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32
        scale = float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol * max(scale, 1.0))


@pytest.mark.parametrize("V", [2, 4])
@pytest.mark.parametrize("G", [2, 8])
def test_fused_plain_matches_jax_kernel_views(V, G):
    rng = np.random.default_rng(V * 10 + G)
    N, C = 100, 32
    rows = rng.standard_normal((V, N, 4 * (V - 1) * C)).astype(np.float32)
    w = rng.uniform(0, 1, (V, N, 2)).astype(np.float32)
    ref = jax_fused(jnp.asarray(rows), jnp.asarray(w), n_views=V, chunk_c=C, n_groups=G,
                    pairs=pair_index_lists(V), block_points=32)
    got = fused_interp_grouped_cosine_plain(torch.tensor(rows), torch.tensor(w), G)
    assert got.shape == (N, G)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("N,scale", [(60, 1.0), (7, 0.5)])
def test_get_novel_view_poses_matches_jax(N, scale):
    rng = np.random.default_rng(N)
    q, _ = np.linalg.qr(rng.normal(0, 1, (3, 3)))
    anchor = np.concatenate([q, rng.normal(0, 1, (3, 1))], -1).astype(np.float32)
    got = camera.get_novel_view_poses(anchor, N=N, scale=scale)
    want = jcam.get_novel_view_poses(anchor, N=N, scale=scale)
    assert got.shape == (N, 3, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_stopwatch_and_trace(tmp_path):
    sw, jsw = profiling.Stopwatch(), JaxStopwatch()
    with sw.phase("encode"):
        pass
    for name, t, n in (("render", 1.25, 4), ("encode", 0.5, 1), ("tables", 0.03125, 2)):
        sw.totals[name], sw.counts[name] = t, n
        jsw.totals[name], jsw.counts[name] = t, n
    assert sw.report() == jsw.report()
    assert sw.report().splitlines()[0].startswith("render ")
    with profiling.trace(str(tmp_path / "t")) as path:
        with profiling.annotate("variants_probe"):
            torch.ones(8).sum()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "variants_probe" for e in events)


def test_train_model_writes_profile_trace(tmp_path):
    """`profile_trace_dir` wraps the training epochs in a torch.profiler
    trace (engine.py:361-365)."""
    cfg = _tiny_train_cfg(tmp_path, val_ep=-1, test_ep=-1, ckpt_ep=-1)
    cfg.max_epoch = 1
    cfg.sanity_check = False
    cfg.profile_trace_dir = str(tmp_path / "trace")
    coach = _coach(cfg, n_train=1)
    coach.train_model()
    files = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)


IMG = 32
VARIANTS = {
    "view_dep_false": {"nerf.view_dep": False},
    "local_radius": {"encoder.feature_sample_local_radius": 1,
                     "encoder.feature_sample_local_dilation": 2},
    "attn_splits_1": {"encoder.attn_splits_list": [1]},
    "fused_v2": {"n_src_views": 2, "precision.fused_cosine": True},
    "fused_v4": {"n_src_views": 4, "precision.fused_cosine": True},
}


def _set(cfg, over):
    for key, value in over.items():
        *head, last = key.split(".")
        node = cfg
        for k in head:
            node = node[k]
        node[last] = value


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_render_variant_matches_jax(variant):
    """The port's image >= 60 dB against the JAX render of the same weights;
    JAX on its direct route (no Pallas kernel but Kernel F's, and that only
    where the port's fused route has a JAX counterpart that keeps the
    scales: none here, see the module docstring)."""
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=2, sample_intvs=48)))
    cfg.encoder = DotDict(dict(cfg.encoder))
    cfg.nerf = DotDict(dict(cfg.nerf))
    cfg.precision = DotDict(dict(dtu_eval_config().precision,
                                 encoder_compute_dtype="float32"))
    _set(cfg, VARIANTS[variant])
    V = cfg.n_src_views
    params, model = _model(cfg)
    d = ge._synthetic_inputs(cfg, 1, IMG, IMG, R=16)
    batch = {"images": d["images"], "extrinsics": d["poses"], "intrinsics": d["intr"],
             "near_fars": d["near_fars"]}
    renderer = Renderer(cfg, model, "cpu")
    out = renderer.forward(batch, mode="test")
    if variant == "local_radius":
        assert renderer.last_route == {"block_ut": None, "color_ut": None}

    jcfg = DotDict(dict(cfg))
    jcfg.precision = DotDict(dict(cfg.precision, banded_kernel=False, block_kernel=False,
                                  color_block_kernel=False, decoder_kernel=False,
                                  fused_cosine=False))
    ref = JaxRenderer(jcfg).forward(params, batch, mode="test")
    for k in ("rgb", "depth", "opacity"):
        assert tuple(out[k].shape) == ref[k].shape and bool(torch.isfinite(out[k]).all())
    mse = float(np.mean((out["rgb"].numpy().astype(np.float64) - ref["rgb"]) ** 2))
    psnr = float("inf") if mse == 0 else -10.0 * np.log10(mse)
    assert psnr >= 60.0, f"{variant} (V={V}): agreement PSNR {psnr:.1f} dB < 60"
    assert float(np.abs(ref["rgb"]).max()) > 0.01


def test_render_view_dep_false_sees_features():
    """The `view_dep: false` image against JAX (as above) fails the 60 dB
    bar when the decoder's feat_info is off by 1e-3, an error far below a
    cosine feature's size: the tamed output layer leaves the image
    following the features."""
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=2, sample_intvs=48)))
    cfg.nerf = DotDict(dict(cfg.nerf, view_dep=False))
    cfg.precision = DotDict(dict(dtu_eval_config().precision,
                                 encoder_compute_dtype="float32"))
    params, model = _model(cfg)
    d = ge._synthetic_inputs(cfg, 1, IMG, IMG, R=16)
    batch = {"images": d["images"], "extrinsics": d["poses"], "intrinsics": d["intr"],
             "near_fars": d["near_fars"]}
    G = sum(cfg.encoder.cos_n_group) if not isinstance(cfg.encoder.cos_n_group, int) \
        else cfg.encoder.cos_n_group

    def off(module, args):
        x = args[0].clone()
        x[..., :G] += 1e-3
        return (x,)
    hook = model.nerf_dec.pts_bias.register_forward_pre_hook(off)
    try:
        out = Renderer(cfg, model, "cpu").forward(batch, mode="test")
    finally:
        hook.remove()
    jcfg = DotDict(dict(cfg))
    jcfg.precision = DotDict(dict(cfg.precision, banded_kernel=False, block_kernel=False,
                                  color_block_kernel=False, decoder_kernel=False,
                                  fused_cosine=False))
    ref = JaxRenderer(jcfg).forward(params, batch, mode="test")
    mse = float(np.mean((out["rgb"].numpy().astype(np.float64) - ref["rgb"]) ** 2))
    assert -10.0 * np.log10(mse) < 60.0


def _no_view_dep(cfg):
    cfg.nerf.view_dep = False


def _local_radius(cfg):
    cfg.encoder.feature_sample_local_radius = 1
    cfg.encoder.feature_sample_local_dilation = 2


@pytest.mark.parametrize("edit,patches", [(_no_view_dep, False), (_no_view_dep, True),
                                           (_local_radius, False)],
                         ids=["view_dep_false", "view_dep_false_strips", "local_radius"])
def test_train_step_variant_matches_jax(edit, patches):
    """configs/train.yaml's step (iid rays: B') and, for `view_dep: false`,
    train_fast.yaml's (8-pixel strips: D'), f32 policy: the loss rtol 1e-5
    and every gradient atol 5e-6 rtol 2e-3 against JAX `make_train_step`,
    fed JAX's ray and depth draws."""
    run_parity(patches=patches, bf16=False, steps=0, edit=edit,
               edit_params=_tame_output if edit is _no_view_dep else None)
