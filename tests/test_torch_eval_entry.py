"""The eval entry of the port with configs/test.yaml's test sets, against the
JAX package, on the CPU.

- `python -m matchnerf_tpu_torch.test --config test --cpu` (its `main`) on
  synthetic 64x32 DTU (its depth maps cropped to that size), LLFF
  (mvsnerf) and Blender trees written by `data/synth.py`, 1 transformer
  layer, S = 8,
  seeded JAX weights passed across by `weights.py`, against the JAX
  `Coach.test_model` on the same trees and weights: each image >= 60 dB
  agreement PSNR, the per-view metrics equal to 1e-4, the JAX package's
  output files; Blender's view renders onto a white background in both
  (the renderer's `setbg_opaque`, only for that set). The encoder runs in
  f32 on both sides (a bf16 encoder rounds at other places in the two
  frameworks, as in test_torch_render.py); the rest is test.yaml as
  shipped (int8 and uint8 tables, the block route, the decoder kernel).
- `CONFIGS["test"]`, `["test_strict"]`, `["test_video"]` and
  `["test_tnt"]` equal the JAX package's resolved YAML files
  (`build_options`, as test.py calls it) on every key.
- `test_model_video` raises for T&T, as in JAX (the video itself:
  test_torch_eval_video.py).
- `score_preds` against the JAX `score_preds` on one folder of pairs, and
  `EvalTools.get_metrics(return_full=True)` against the JAX one.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from matchnerf_tpu import config as jconfig
from matchnerf_tpu import engine as jengine
from matchnerf_tpu import metrics as jmetrics
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.utils import DotDict as JDotDict
from matchnerf_tpu.utils import to_plain_dict
from matchnerf_tpu_torch import metrics, score_preds
from matchnerf_tpu_torch.config import CONFIGS, parse_arguments
from matchnerf_tpu_torch.data import synth
from matchnerf_tpu_torch.data.png import write_png
from matchnerf_tpu_torch.renderer import Renderer
from matchnerf_tpu_torch.weights import state_dict_from_jax

SMALL = (64, 32)                     # img_wh of the trees of these tests


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tiny models (see test_torch_train_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    synth.write_dtu_scene(str(root / "DTU"), str(root / "dtu_meta"), *SMALL)
    synth.write_llff_tree(str(root / "llff"), str(root / "llff_meta"), *SMALL)
    synth.write_blender_tree(str(root / "blender"), str(root / "blender_meta"), *SMALL)
    return root


@pytest.mark.parametrize("name", ["test", "test_strict", "test_video", "test_tnt"])
def test_eval_config_matches_yaml(name):
    want = to_plain_dict(jconfig.build_options(JDotDict(yaml=name)))
    got = json.loads(json.dumps(CONFIGS[name]()))
    assert got == want


def _set_args(trees, sets):
    """--data_test.* of the given sets (the others left out)."""
    args = {}
    for name in ("dtu", "llff", "blender", "tnt"):
        if name not in sets:
            args[f"data_test.{name}"] = ""
            continue
        args[f"data_test.{name}.root_dir"] = str(trees / ("DTU" if name == "dtu" else name))
        args[f"data_test.{name}.meta_dir"] = str(trees / f"{name}_meta")
        args[f"data_test.{name}.max_len"] = 1
        args[f"data_test.{name}.img_wh"] = "%d,%d" % SMALL
    return args


def _run_both(tmp_path, trees, config, sets, **over):
    """The port's entry and the JAX Coach on the same trees and weights ->
    (port result, JAX result, [(dataset, port render, JAX render, setbg)])."""
    args = dict(_set_args(trees, sets), **{
        "encoder.num_transformer_layers": 1, "encoder.pretrain_weight": "",
        "nerf.sample_intvs": 8, "precision.encoder_compute_dtype": "float32"}, **over)
    argv = [f"--{k}={v}" for k, v in args.items()]
    jcfg = jconfig.build_options(JDotDict(parse_arguments(argv + [f"--yaml={config}"])))
    jcfg.output_path = str(tmp_path / "jax")
    jcfg.parallel.data_parallel = 1
    params = jax_init(jax.random.PRNGKey(0), jcfg)
    # a density head that leaves the rays partly transparent, so the
    # background reaches the image (seeded weights give opacity ~1)
    head = params["nerf_dec"]["out_alpha_linear"][1]
    head["w"], head["b"] = head["w"] * 0.01, head["b"] * 0.0 + 0.05
    ckpt = str(tmp_path / "weights.pth")
    torch.save({"model": state_dict_from_jax(params)}, ckpt)

    jcoach = jengine.Coach(jcfg)
    jcoach.load_dataset(["test"])
    jcoach.params = params
    renders = {"jax": [], "port": []}
    jfwd = jcoach.renderer.forward

    def jax_forward(*a, **k):
        out = jfwd(*a, **k)
        renders["jax"].append((np.asarray(out["rgb"]), jcoach.renderer.nerf_setbg_opaque))
        return out
    jcoach.renderer.forward = jax_forward
    video = bool(jcfg.nerf.get("render_video"))
    want = jcoach.test_model_video() if video else jcoach.test_model(save_images=True)

    from matchnerf_tpu_torch.test import main
    tfwd = Renderer.forward

    def port_forward(self, *a, **k):
        out = tfwd(self, *a, **k)
        renders["port"].append((out["rgb"].numpy(), self.setbg_opaque,
                                out["opacity"].numpy()))
        return out
    Renderer.forward = port_forward
    try:
        got = main(["--config", config, "--cpu", f"--load={ckpt}",
                    f"--output_root={tmp_path}", "--name=port", *argv])
    finally:
        Renderer.forward = tfwd
    assert len(renders["port"]) == len(renders["jax"]) == len(sets)
    return got, want, renders


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


def test_entry_test_sets_match_jax(tmp_path, trees):
    sets = ("dtu", "llff", "blender")
    got, want, renders = _run_both(tmp_path, trees, "test", sets,
                                   **{"data_test.blender.report_full_scores": "true"})
    assert list(got) == list(want) == list(sets)
    for name, (port, psetbg, opacity), (ref, jsetbg) in zip(sets, renders["port"],
                                                             renders["jax"]):
        assert psetbg == jsetbg == (name == "blender"), name
        psnr = _psnr(port, ref)
        assert psnr >= 60.0, f"{name}: agreement PSNR {psnr:.1f} dB < 60"
        if name == "blender":       # the white background reaches the image
            assert float((1.0 - opacity).mean()) > 0.1
        for k, v in want[name].items():
            np.testing.assert_allclose(got[name][k], v, atol=1e-4, err_msg=f"{name} {k}")
    assert "PSNR_Full" in got["blender"] and "PSNR_Full" not in got["llff"]
    out = tmp_path / "port" / "test"
    for name in sets:
        assert (out / f"0results_{name}.txt").is_file()
        assert any(f.endswith(".png") for f in os.listdir(out / name))


def test_video_raises_for_tnt(tmp_path):
    from matchnerf_tpu_torch.engine import Coach

    class TNTSet:
        def __len__(self):
            return 1

        def get_name(self):
            return "tnt"

    from matchnerf_tpu_torch.data.loader import DataLoader
    cfg = CONFIGS["test_video"]()
    cfg.output_root = str(tmp_path)
    cfg.name = "tnt"
    coach = Coach(cfg, device="cpu")
    coach.test_loaders = [DataLoader(TNTSet())]
    with pytest.raises(ValueError, match="Unknown dataset for rendering video tnt"):
        coach.test_model_video()


def test_score_preds_matches_jax(tmp_path):
    from matchnerf_tpu import score_preds as jscore
    rng = np.random.default_rng(5)
    for name in ("scan1_view24_src20_21_22", "scan2_view03_src01_02_04", "odd"):
        gt = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
        pred = np.clip(gt.astype(np.int16) + rng.integers(-9, 10, gt.shape), 0, 255)
        write_png(str(tmp_path / f"{name}_gt.png"), gt)
        write_png(str(tmp_path / f"{name}_pred.png"), pred.astype(np.uint8))
    jscore.main([f"--pred_folder={tmp_path}"])
    with open(tmp_path / "0scores.json") as f:
        want = json.load(f)
    os.remove(tmp_path / "0scores.json")
    score_preds.main([f"--pred_folder={tmp_path}", "--cpu"])
    with open(tmp_path / "0scores.json") as f:
        got = json.load(f)
    assert sorted(got) == sorted(want) == ["odd", "scan1", "scan2"]
    for scene in want:
        for a, b in zip(got[scene], want[scene]):
            assert (a["view_idx"], a["src_idx"]) == (b["view_idx"], b["src_idx"])
            for k, v in b["metrics"].items():
                assert (np.isnan(v) and np.isnan(a["metrics"][k])) or \
                    abs(a["metrics"][k] - v) <= 1e-6, (scene, k)


@pytest.mark.parametrize("masked", [False, True])
def test_get_metrics_return_full_matches_jax(masked):
    rng = np.random.default_rng(4)
    pred = rng.uniform(0, 1, (40, 50, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.05, pred.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(0, 1, (40, 50)) < 0.3 if masked else None
    a, b = metrics.EvalTools("cpu"), jmetrics.EvalTools()
    a.set_inputs(pred, gt, mask)
    b.set_inputs(pred, gt, mask)
    got = a.get_metrics(["PSNR", "SSIM"], return_full=True)
    want = b.get_metrics(["PSNR", "SSIM"], return_full=True)
    assert list(got) == list(want) == ["PSNR", "PSNR_Full", "SSIM", "SSIM_Full"]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
