"""The eval and video entry of the port against the JAX package, on the CPU.

- the render-path generators (interpolate; spiral on synthetic c2ws_all)
  against matchnerf_tpu.camera's, within 1e-6;
- `Renderer.forward(render_video=True)` with the decoder and precision of
  configs/demo_own.yaml and `precision.fused_cosine` on (f32 encoder, as
  test_torch_render.py: a bf16 encoder rounds at other places in the two
  frameworks), 3 frames at a tiny width, each >= 60 dB against the JAX
  video render: on int8 tables against the JAX unfused route (the JAX
  fused route drops the int8 scales, test_torch_fused_cosine.py), on f32
  tables against the JAX fused route;
- the port's `COLMAPDataset` on the printer scene against the JAX one:
  images, extrinsics, intrinsics, near/fars and c2ws_all exact;
- `python -m matchnerf_tpu_torch.test --config demo_own --cpu` (its `main`)
  at 64x32, video (3 frames) and test modes: the outputs are written, the
  checkpoint given with --load is the one rendered, and the reported PSNR
  and SSIM equal the JAX `metrics` on the same prediction within 1e-6;
- `demo_own_config()` and `test_video_own_config()` equal
  configs/demo_own.yaml and configs/test_video_own.yaml on `DEMO_KEYS`, the
  `test_video_own` entry runs at a tiny size on the CPU, and the port's
  metrics equal the JAX ones.
"""
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu import camera as jcam
from matchnerf_tpu import metrics as jmetrics
from matchnerf_tpu.data.llff import COLMAPDataset as JaxCOLMAP
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.renderer import Renderer as JaxRenderer
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch import camera, metrics
from matchnerf_tpu_torch import config as tconfig
from matchnerf_tpu_torch.config import CONFIGS, DEMO_KEYS, demo_own_config
from matchnerf_tpu_torch.data.colmap import COLMAPDataset
from matchnerf_tpu_torch.data.loader import collate
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF, init_matchnerf
from matchnerf_tpu_torch.renderer import Renderer
from matchnerf_tpu_torch.weights import state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_ROOT = os.path.join(REPO, "docs", "demo_data")


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


def _synthetic_c2ws(n, seed):
    """n camera-to-world poses: the 4 synthetic cameras, then jittered copies."""
    d = ge._synthetic_inputs(ge._tiny_cfg(), 1, 8, 8, 4, seed=seed)
    sq = np.repeat(np.eye(4, dtype=np.float32)[None], 4, 0)
    sq[:, :3] = d["poses"][0, :, :3]
    c2ws = np.linalg.inv(sq.astype(np.float64))
    if n <= 4:
        return c2ws[:n]
    extra = c2ws[:n - 4].copy()
    extra[:, :3, 3] += np.random.default_rng(seed).normal(0, 0.05, (n - 4, 3))
    return np.concatenate([c2ws, extra])


@pytest.mark.parametrize("mode", ["interpolate", "spiral"])
def test_render_paths_match_jax(mode):
    if mode == "interpolate":
        c2ws = _synthetic_c2ws(3, 0)
        for n in (3, 24, 7):
            np.testing.assert_allclose(camera.get_interpolate_render_path(c2ws, n),
                                       jcam.get_interpolate_render_path(c2ws, n),
                                       atol=1e-6, rtol=0)
        return
    c2ws_all = _synthetic_c2ws(6, 1)
    for nf, scale in (((2.0, 4.5), 0.3), ((1.2, 9.0), 0.5)):
        got = camera.get_spiral_render_path(c2ws_all, nf, rads_scale=scale, n_frames=24)
        want = jcam.get_spiral_render_path(c2ws_all, nf, rads_scale=scale, n_frames=24)
        assert got.shape == (24, 4, 4)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


DEMO_PREC = dict(demo_own_config().precision, encoder_compute_dtype="float32",
                 fused_cosine=True)


@pytest.mark.parametrize("tables", ["int8_vs_jax_unfused", "f32_vs_jax_fused"])
def test_video_matches_jax(tables):
    H, W = 32, 32
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=2, sample_intvs=48)))
    cfg.decoder = DotDict(dict(cfg.decoder, **{k: demo_own_config().decoder[k] for k in (
        "raytrans_posenc", "density_maskfill", "raytrans_act")}))
    cfg.nerf = DotDict(dict(cfg.nerf, video_n_frames=3))
    prec = dict(DEMO_PREC)
    if tables.startswith("f32"):
        prec["cond_sample_dtype"] = "float32"
    cfg.precision = DotDict(prec)
    jcfg = DotDict(dict(cfg))
    jcfg.precision = DotDict(prec, fused_cosine=tables.startswith("f32"))
    params = jax_init(jax.random.PRNGKey(0), cfg)
    model = MatchNeRF(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    d = ge._synthetic_inputs(cfg, 1, H, W, R=16)
    # each frame of 3 is a source camera's pose seen with the target's
    # intrinsics; a sub-pixel principal-point offset keeps the border rays
    # off the exact image border, where the strict in-frustum mask would
    # flip on the last bit of the projection
    intr = d["intr"].copy()
    intr[:, -1, :2, 2] += (0.37, 0.29)
    batch = {"images": d["images"], "extrinsics": d["poses"], "intrinsics": intr,
             "near_fars": d["near_fars"]}
    ref = JaxRenderer(jcfg).forward(params, batch, mode="test", render_video=True)
    renderer = Renderer(cfg, model, "cpu")
    out = renderer.forward(batch, mode="test", render_video=True)
    assert len(renderer.frame_routes) == 3
    for k in ("rgb", "depth", "opacity"):
        assert tuple(out[k].shape) == ref[k].shape and ref[k].shape[0] == 3
        assert torch.isfinite(out[k]).all()
    for f in range(3):
        psnr = _psnr(out["rgb"][f].numpy(), ref["rgb"][f])
        assert psnr >= 60.0, f"frame {f}: agreement PSNR {psnr:.1f} dB < 60"
    assert float(ref["opacity"].max()) > 0.01


def test_colmap_dataset_matches_jax():
    kw = dict(n_views=3, img_wh=(256, 160), scene_list=["printer"],
              test_views_method="fixed", nf_mode="minmax")
    mine, theirs = COLMAPDataset(DEMO_ROOT, "test", **kw), JaxCOLMAP(DEMO_ROOT, "test", **kw)
    assert len(mine) == len(theirs) == 1 and mine.get_name() == theirs.get_name()
    a, b = mine[0], theirs[0]
    assert sorted(a) == sorted(b)
    for k in ("images", "extrinsics", "intrinsics", "near_fars", "view_ids", "img_wh",
              "c2ws_all"):
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["scene"] == b["scene"] == "printer"
    assert a["images"].shape == (4, 160, 256, 3)


def _run_entry(tmp_path, ckpt, *extra):
    from matchnerf_tpu_torch.test import main
    return main(["--config", "demo_own", "--cpu", f"--load={ckpt}",
                 f"--output_root={tmp_path}", "--precision.fused_cosine=true",
                 "--data_test.colmap.img_wh=64,32", "--nerf.video_n_frames=3",
                 "--nerf.sample_intvs=32", "--encoder.num_transformer_layers=1", *extra])


def test_entry_video_and_test_modes(tmp_path):
    cfg = demo_own_config()
    cfg.encoder.num_transformer_layers = 1
    cfg.nerf.sample_intvs = 32
    model = init_matchnerf(cfg, torch.Generator().manual_seed(7))
    ckpt = os.path.join(tmp_path, "weights.pth")
    torch.save({"model": {f"module.{k}": v for k, v in model.state_dict().items()}}, ckpt)

    videos = _run_entry(tmp_path, ckpt)
    out_dir = os.path.join(tmp_path, "test_video", "demo", "test_videos", "colmap")
    name = "printer_view00_src02_01_00"
    files = os.listdir(out_dir)
    assert f"{name}.png" in files
    assert f"{name}.mp4" in files or f"{name}.npy" in files
    assert len(videos) == 1 and videos[0].shape == (3, 32, 64, 3)
    assert np.isfinite(videos[0]).all() and 0.0 <= videos[0].min() <= videos[0].max() <= 1.0
    if f"{name}.npy" in files:
        frames = np.load(os.path.join(out_dir, f"{name}.npy"))
        np.testing.assert_array_equal(frames, (videos[0] * 255).astype(np.uint8))

    sums = _run_entry(tmp_path, ckpt, "--nerf.render_video=false")
    test_dir = os.path.join(tmp_path, "test_video", "demo", "test")
    assert os.path.isfile(os.path.join(test_dir, "colmap", f"{name}.png"))
    assert os.path.isfile(os.path.join(test_dir, "0results_colmap.txt"))
    # the same render from the checkpoint's weights, scored by the JAX metrics
    cfg.precision.fused_cosine = True
    cfg.data_test.colmap.img_wh = [64, 32]
    batch = collate([COLMAPDataset(DEMO_ROOT, "test", img_wh=(64, 32),
                                   scene_list=["printer"], test_views_method="fixed",
                                   nf_mode="minmax")[0]])
    pred = Renderer(cfg, model.eval(), "cpu").forward(batch)["rgb"].numpy().reshape(32, 64, 3)
    tools = jmetrics.EvalTools()
    tools.set_inputs(pred, batch["images"][0, -1])
    want = tools.get_metrics(["PSNR", "SSIM"])
    got = sums["colmap"]
    assert abs(got["PSNR"][0] - want["PSNR"]) <= 1e-6
    assert abs(got["SSIM"][0] - want["SSIM"]) <= 1e-6
    assert np.isnan(got["LPIPS"][0])


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    pred = rng.uniform(0, 1, (40, 50, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.05, pred.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(0, 1, (40, 50)) < 0.3
    assert abs(metrics.psnr(pred, gt) - jmetrics.psnr(pred, gt)) <= 1e-6
    assert abs(metrics.psnr(pred, gt, mask) - jmetrics.psnr(pred, gt, mask)) <= 1e-6
    assert abs(metrics.ssim(pred, gt) - jmetrics.ssim(pred, gt)) <= 1e-6
    for m in (None, mask):
        a, b = metrics.EvalTools("cpu"), jmetrics.EvalTools()
        a.set_inputs(pred, gt, m)
        b.set_inputs(pred, gt, m)
        got, want = a.get_metrics(["PSNR", "SSIM"]), b.get_metrics(["PSNR", "SSIM"])
        for k in ("PSNR", "SSIM"):
            assert abs(got[k] - want[k]) <= 1e-6


def _assert_matches_yaml(name, mine):
    from matchnerf_tpu.config import load_options
    opt = load_options(os.path.join(REPO, "configs", f"{name}.yaml"))
    for key in DEMO_KEYS:
        a, b = opt, mine
        for part in key.split("."):       # absent on both sides reads as the default
            a, b = a.get(part), b.get(part)
        assert a == b, f"{key}: yaml {a!r} vs dict {b!r}"


def test_demo_own_config_matches_yaml():
    mine = demo_own_config()
    _assert_matches_yaml("demo_own", mine)
    assert mine.precision.fused_cosine is False


def test_video_own_config_matches_yaml():
    mine = tconfig.test_video_own_config()
    _assert_matches_yaml("test_video_own", mine)
    assert mine.nerf.sample_intvs == 256 and mine.nerf.rand_rays_test == 5012
    assert mine.data_test.colmap.img_wh == [960, 640] and mine.precision.fused_cosine is False
    assert CONFIGS["test_video_own"] is tconfig.test_video_own_config

