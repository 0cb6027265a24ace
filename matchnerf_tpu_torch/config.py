"""The eval render's, the demo entry's and the training run's
configurations as Python dicts, the entries' `--key=value` overrides and
the run directory (`process_options`).

`dtu_eval_config()` (CONFIGS["test"]) is configs/base.yaml overlaid with
configs/test.yaml as shipped (`precision.block_kernel` and
`precision.color_block_kernel` on), every key, with its DTU, LLFF, Blender
and T&T test sets; CONFIGS["test_strict"], ["test_video"] and
["test_tnt"] are configs/test_strict.yaml, test_video.yaml and
test_tnt.yaml. `dtu_eval_per_ray_config()` is CONFIGS["test"] with
`precision.block_kernel: false`: the per-ray cosine-prior path.
`base_config()` is configs/base.yaml, every key;
`dtu_train_config()` (CONFIGS["train"]) overlays configs/train.yaml and
`dtu_train_fast_config()` (CONFIGS["train_fast"]) configs/train_fast.yaml
(8-pixel ray strips, the block route) and `ibrnet_train_config()`
(CONFIGS["train_ibrnet"]) configs/train_ibrnet.yaml (IBRNet scenes at
1008x756, the LLFF test set): every key, as the JAX package's
`build_options` resolves them, for the training step and the loop around
it (its validation and test renders take bf16 tables). They exist so the
port runs where PyYAML is not installed; CPU tests hold them equal to what
`matchnerf_tpu.config` loads from the YAML files.
`encoder.attention_backend` and `encoder.conv_data_format` are TPU backend
and layout knobs: carried as keys, they change nothing here.
`demo_own_config()` is CONFIGS["test"] with the keys of
configs/demo_own.yaml that the entry (`matchnerf_tpu_torch/test.py`)
reads (the IBR decoder variant on the in-repo COLMAP printer scene, video
mode); `precision.fused_cosine` stays as base.yaml sets it (off) and the
entry's override turns it on.
`test_video_own_config()` adds configs/test_video_own.yaml (S = 256,
5012-ray slices, 960x640). `precision.decoder_matmul_dtype`, absent from
the YAML files, reads as float32; bf16 picks Kernel C's bf16 route.
"""
from __future__ import annotations

import json
import logging
import os
import random
import string
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from .parallel import distributed as dist
from .utils.containers import DotDict

log = logging.getLogger(__name__)


# every key the eval render reads, as dotted paths
SLICE_KEYS = [
    "n_src_views", "batch_size",
    "encoder.attn_splits_list", "encoder.cos_n_group",
    "encoder.num_transformer_layers", "encoder.feature_upsampler",
    "encoder.upsample_factor", "encoder.wo_self_attn",
    "encoder.feature_sample_local_radius",
    "decoder.net_width", "decoder.net_depth", "decoder.skip", "decoder.posenc",
    "decoder.raytrans_posenc", "decoder.density_maskfill", "decoder.raytrans_act",
    "nerf.legacy_coord", "nerf.wo_render_interval", "nerf.view_dep",
    "nerf.depth", "nerf.sample_intvs", "nerf.rand_rays_test",
    "precision.encoder_compute_dtype", "precision.cond_sample_dtype",
    "precision.color_sample_dtype", "precision.banded_kernel",
    "precision.block_kernel", "precision.decoder_kernel",
    "precision.color_block_kernel", "precision.decoder_matmul_dtype",
]


def base_config() -> DotDict:
    """configs/base.yaml as the JAX package loads it, every key."""
    return DotDict({
        "name": None, "yaml": None, "model": "matchnerf", "seed": 0, "load": None,
        "n_src_views": 3, "batch_size": 1, "max_epoch": 12,
        "sync_loss_every_step": False, "resume": False, "output_root": "outputs",
        "vis_depth": False, "separate_save": False,
        "encoder": {
            "attn_splits_list": [2],
            "cos_n_group": [2, 8],
            "pretrain_weight": "configs/pretrained_models/gmflow_sintel-0c07dcb3.pth",
            "num_transformer_layers": 6,
            "feature_upsampler": "network",
            "upsample_factor": 2,
            "wo_self_attn": False,
            "feature_sample_local_radius": 0,
            "feature_sample_local_dilation": 1,
        },
        "decoder": {
            "net_width": 128,
            "net_depth": 6,
            "skip": [4],
            "posenc": {"L_3D": 10, "L_view": 0},
            "raytrans_posenc": False,
            "density_maskfill": False,
            "raytrans_act": "ReLU",
        },
        "nerf": {
            "legacy_coord": True,
            "wo_render_interval": True,
            "view_dep": True,
            "depth": {"param": "metric"},
            "sample_intvs": 128,
            "sample_stratified": True,
            "density_noise_reg": None,
            "render_video": False,
        },
        "parallel": {
            "mesh_axes": ["data"], "data_parallel": -1, "multihost": False,
            "coordinator_address": None, "num_processes": None, "process_id": None,
            "shard_encoder_streams": True, "shard_encoder_streams_eval": True,
        },
        "precision": {
            "cond_sample_dtype": "bfloat16",
            "encoder_compute_dtype": "float32",
            "remat_encoder": False,
            "fused_cosine": False,
            "banded_gather": False,
            "banded_kernel": False,
            "block_kernel": False,
            "decoder_kernel": False,
            "color_sample_dtype": "float32",
        },
        "tb": None,
    })


def _data(name: str, root: str, img_wh, **extra) -> dict:
    """One data_* block of the YAML files (max_len -1 unless given)."""
    return {"root_dir": root, "dataset_name": name, "img_wh": img_wh, "num_workers": 4,
            "max_len": -1, **extra}


def _dtu_data(max_len: int = -1) -> dict:
    return _data("dtu", "data/DTU", [640, 512], max_len=max_len)


def dtu_eval_config() -> DotDict:
    """configs/base.yaml + configs/test.yaml, every key (CONFIGS["test"]):
    the eval render as shipped (bf16 encoder, int8 feature and uint8 colour
    tables, the block, banded and decoder kernels) over the DTU, LLFF,
    Blender and T&T test sets."""
    return override_options(base_config(), {
        "yaml": "test", "tb": False, "batch_size": 1,
        "load": "configs/pretrained_models/matchnerf_3v.pth",
        "nerf": {"rand_rays_test": 20480},
        "precision": {"encoder_compute_dtype": "bfloat16", "cond_sample_dtype": "int8",
                      "color_sample_dtype": "uint8", "banded_kernel": True,
                      "block_kernel": True, "decoder_kernel": True,
                      "color_block_kernel": True},
        "data_test": {
            "dtu": dict(_dtu_data(), test_views_method="nearest"),
            "llff": _data("llff", "data/nerf_llff_data", [960, 640], scene_list=None,
                               test_views_method="nearest"),
            "blender": _data("blender", "data/nerf_synthetic", [800, 800],
                                  scene_list=None, test_views_method="nearest"),
            "tnt": _data("tnt", "data/tnt_data", [960, 640], scene_list=None,
                              test_views_method="nearest", eval_mode="mvsnerf",
                              nf_mode="minmax"),
        },
    }, warn=False)


def dtu_eval_per_ray_config() -> DotDict:
    """CONFIGS["test"] with `precision.block_kernel: false`: the per-ray
    cosine-prior path."""
    cfg = dtu_eval_config()
    cfg.precision.block_kernel = False
    return cfg


def strict_eval_config() -> DotDict:
    """... + configs/test_strict.yaml (CONFIGS["test_strict"]):
    `precision.strict`, which `effective_precision` resolves to f32 tables,
    encoder and decoder and no kernel but Kernel A's f32 route."""
    cfg = dtu_eval_config()
    cfg.yaml = "test_strict"
    cfg.precision.strict = True
    return cfg


def video_eval_config() -> DotDict:
    """... + configs/test_video.yaml (CONFIGS["test_video"]): 60-frame videos
    of every test set, LLFF's target fixed."""
    cfg = dtu_eval_config()
    cfg.yaml = "test_video"
    cfg.nerf.update({"rand_rays_test": 20480, "render_video": True, "video_n_frames": 60,
                     "video_rads_scale": 0.3})
    cfg.data_test.llff.test_views_method = "fixed"
    return cfg


def tnt_eval_config() -> DotDict:
    """configs/base.yaml + configs/test_tnt.yaml (CONFIGS["test_tnt"]; its
    parent is base.yaml, so the precision is base.yaml's): the T&T test set
    alone, with 3 source views, each prediction, ground truth and source
    saved apart for `score_preds`."""
    return override_options(base_config(), {
        "yaml": "test_tnt", "tb": False, "batch_size": 1,
        "load": "configs/pretrained_models/matchnerf_3v.pth", "separate_save": True,
        "nerf": {"rand_rays_test": 20480},
        "data_test": {"tnt": _data("tnt", "data/tnt_data", [960, 640], scene_list=None,
                                        test_views_method="nearest", eval_mode="mvsnerf",
                                        nf_mode="minmax", n_views=3)},
    }, warn=False)


def dtu_train_config() -> DotDict:
    """configs/base.yaml + configs/train.yaml, every key (CONFIGS["train"]):
    the training step, and the loop around it with its validation and test
    renders, which take bf16 feature tables (base.yaml's
    cond_sample_dtype), uint8 colours and the block, banded and decoder
    kernels."""
    cfg = override_options(base_config(), {
        "yaml": "train",
        "tb": True, "batch_size": 1, "max_epoch": 12, "sanity_check": False,
        "save_test_image": False,
        "nerf": {"rand_rays_train": 1024, "rand_rays_val": 4096, "rand_rays_test": 4096},
        "data_train": _dtu_data(),
        "data_val": _dtu_data(5),
        "data_test": {"dtu": _dtu_data(),
                      "llff": _data("llff", "data/nerf_llff_data", [960, 640]),
                      "blender": _data("blender", "data/nerf_synthetic", [800, 800])},
        "precision": {"encoder_compute_dtype": "bfloat16", "block_kernel": True,
                      "decoder_kernel": True, "color_sample_dtype": "uint8",
                      "banded_kernel": True, "decoder_compute_dtype": "bfloat16"},
        "encoder": {"attention_backend": "fused", "conv_data_format": "NCHW"},
        "loss_weight": {"render": 1, "render_fine": None},
        "optim": {
            "lr_enc": 5e-5,
            "lr_dec": 5e-4,
            "clip_enc": 1.0,
            "algo": {"type": "AdamW", "weight_decay": 1e-4},
            "sched": {"type": "OneCycleLR", "pct_start": 0.05, "cycle_momentum": False,
                      "anneal_strategy": "cos"},
        },
        "freq": {"scalar": 20, "log_ep": 1, "ckpt_ep": 1, "ckpt_it": 0.1, "val_ep": -1,
                 "val_it": 0.5, "test_ep": 1, "test_ep_start": 0, "test_it": -1},
    }, warn=False)
    return cfg


def dtu_train_fast_config() -> DotDict:
    """... + configs/train_fast.yaml (CONFIGS["train_fast"]): 8-pixel ray
    strips, the block route."""
    cfg = dtu_train_config()
    cfg.yaml = "train_fast"
    cfg.nerf.train_ray_patches = True
    return cfg


def ibrnet_train_config() -> DotDict:
    """configs/base.yaml + configs/train_ibrnet.yaml, every key
    (CONFIGS["train_ibrnet"]): train.yaml's step and policies on the IBRNet
    scenes at 1008x756 (the encoder resizes them to 768x1024, so its
    windows at `attn_splits_list: [4]` hold 24 x 32 = 768 tokens), the IBR
    decoder variant, 23552-ray validation and test slices, a sanity
    validation and test before the first step, validation once an epoch
    and the LLFF test set (eval_mode gpnr) every 5."""
    cfg = dtu_train_config()
    ibr = lambda **extra: _data("ibrnet", "data/IBRNet", [1008, 756], **extra)
    override_options(cfg, {
        "yaml": "train_ibrnet", "max_epoch": 60, "sanity_check": True,
        "encoder": {"attn_splits_list": [4]},
        "decoder": {"density_maskfill": True, "raytrans_posenc": True,
                    "raytrans_act": "ELU"},
        "nerf": {"rand_rays_val": 23552, "rand_rays_test": 23552},
        "data_train": ibr(), "data_val": ibr(max_len=4),
        "freq": {"ckpt_ep": 5, "ckpt_it": -1, "val_it": 1.0, "test_ep": 5},
    }, warn=False)
    cfg.data_test = {"llff": _data("llff", "data/nerf_llff_data", [1008, 756],
                                   eval_mode="gpnr", report_full_scores=True)}
    return cfg


def demo_own_config() -> DotDict:
    cfg = dtu_eval_config()
    cfg.update({"yaml": "demo_own", "name": "test_video/demo", "seed": 0,
                "load": "configs/pretrained_models/matchnerf_3v_ibr.pth",
                "output_root": "outputs", "vis_depth": False, "separate_save": False})
    cfg.decoder.update({"raytrans_posenc": True, "density_maskfill": True,
                        "raytrans_act": "ELU"})
    cfg.nerf.update({"render_video": True, "save_frames": False, "save_gif": True,
                     "video_n_frames": 24, "video_rads_scale": 0.3,
                     "video_pts_rates": 2.0})
    cfg.precision.fused_cosine = False
    cfg.data_test = {"colmap": {
        "root_dir": "docs/demo_data", "dataset_name": "colmap", "img_wh": [256, 160],
        "num_workers": 4, "max_len": -1, "scene_list": ["printer"],
        "test_views_method": "fixed", "render_path_mode": "interpolate",
        "nf_mode": "minmax"}}
    return cfg


def test_video_own_config() -> DotDict:
    """configs/base.yaml + configs/test.yaml + configs/test_video_own.yaml:
    the IBR decoder variant at S = 256 on 5012-ray slices, 72 frames of the
    printer scene at 960x640."""
    cfg = demo_own_config()
    cfg.name = "test_video/colmap_own"
    cfg.encoder.attn_splits_list = [4]
    cfg.nerf.update({"sample_intvs": 256, "rand_rays_test": 5012, "video_n_frames": 72,
                     "video_pts_rates": 1.0})
    cfg.data_test.colmap.img_wh = [960, 640]
    return cfg


# every key the eval and video entry reads, as dotted paths
DEMO_KEYS = SLICE_KEYS + [
    "name", "seed", "load", "output_root", "vis_depth", "separate_save",
    "nerf.render_video", "nerf.save_frames", "nerf.save_gif", "nerf.video_n_frames",
    "nerf.video_rads_scale", "nerf.video_pts_rates", "precision.fused_cosine",
    "data_test.colmap",
]

CONFIGS = {"test": dtu_eval_config, "test_strict": strict_eval_config,
           "test_video": video_eval_config, "test_tnt": tnt_eval_config,
           "demo_own": demo_own_config, "test_video_own": test_video_own_config,
           "train": dtu_train_config, "train_fast": dtu_train_fast_config,
           "train_ibrnet": ibrnet_train_config}


def _parse_value(text: Optional[str]):
    """A command-line value as the JAX package's YAML parse reads the common
    cases: empty -> None, true/false/null, int, float, a flow list `[a, b]`
    (each item read so), `a,b,` -> a list (digit items as int), anything
    else a string."""
    if text is None or text == "":
        return None
    if text.startswith("[") and text.endswith("]"):
        return [_parse_value(x.strip()) for x in text[1:-1].split(",") if x.strip()]
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none", "~"):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if "," in text:
        return [int(x) if x.isdigit() else x for x in text.split(",") if x.strip()]
    return text


def parse_arguments(args: List[str]) -> DotDict:
    """`--a.b=value`, `--a.b value`, `--flag` (True) and `--flag!` (False)
    -> a nested dict of overrides (config.py:38)."""
    out: Dict = {}
    i = 0
    while i < len(args):
        arg = args[i]
        if not arg.startswith("--"):
            raise ValueError(f"arguments must start with '--': {arg}")
        if "=" in arg:
            key, value = arg[2:].split("=", 1)
            value = _parse_value(value)
        elif arg.endswith("!"):
            key, value = arg[2:-1], False
        elif i + 1 < len(args) and not args[i + 1].startswith("--"):
            key, value = arg[2:], _parse_value(args[i + 1])
            i += 1
        else:
            key, value = arg[2:], True
        sub = out
        parts = key.split(".")
        for k in parts[:-1]:
            sub = sub.setdefault(k, {})
        if parts[-1] in sub:
            raise ValueError(f"duplicate command-line key: {key}")
        sub[parts[-1]] = value
        i += 1
    return DotDict(out)


def override_options(cfg: DotDict, over, key_stack=(), warn: bool = True) -> DotDict:
    """Merge `over` into `cfg` (config.py:87); a key the config does not
    have is added, with a warning unless `warn` is False (a YAML child
    adding keys to its parent)."""
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(cfg.get(key), dict):
            override_options(cfg[key], value, (*key_stack, key), warn)
            continue
        if warn and key not in cfg:
            log.warning('"%s" not found in the configuration, adding it',
                        ".".join((*key_stack, key)))
        cfg[key] = value
    return cfg


def entry_config(argv: List[str], default: str):
    """An entry's command line -> (config name, device, the config with its
    overrides): `--config` names a CONFIGS entry (default `default`),
    `--cpu` picks the CPU over the card."""
    opts = parse_arguments(argv)
    name = opts.pop("config", default)
    if name not in CONFIGS:
        raise SystemExit(f"unknown --config {name!r}; the port has {sorted(CONFIGS)}")
    device = "cpu" if opts.pop("cpu", False) else "cuda"
    return name, device, override_options(CONFIGS[name](), opts)


def process_options(cfg: DotDict) -> DotDict:
    """The run's name and directory (config.py:98): a timestamp when no name
    is given; a name with `_debug` cuts the data to 20 / 1 / 1 samples and
    the run to 2 epochs; seed != 0 adds `_seed{seed}`, no seed a random
    suffix; python's and numpy's global generators take the seed. Under
    several processes every rank takes rank 0's name (config.py:159-173:
    the timestamp and the random suffix differ per process). Creates
    `output_path` = <output_root>/<name>; rank 0 writes the options there as
    options.json (the port reads no YAML) and the command to run.bash."""
    if cfg.get("name") is None:
        cfg.name = time.strftime("%b%d_%H%M%S").lower()
    if "_debug" in str(cfg.name):
        if cfg.get("data_train"):
            cfg.data_train.max_len = 20
        if cfg.get("data_val"):
            cfg.data_val.max_len = 1
        for data_cfg in (cfg.get("data_test") or {}).values():
            if data_cfg:
                data_cfg.max_len = 1
        cfg.max_epoch = 2
    if cfg.get("seed") is not None:
        random.seed(int(cfg.seed))
        np.random.seed(int(cfg.seed))
        if cfg.seed != 0:
            cfg.name = f"{cfg.name}_seed{cfg.seed}"
    else:
        cfg.name = f"{cfg.name}_" + "".join(random.choice(string.ascii_uppercase)
                                             for _ in range(4))
    if dist.process_count() > 1:
        cfg.name = dist.broadcast_str(str(cfg.name))
    cfg.output_path = os.path.join(str(cfg.get("output_root") or "outputs"), str(cfg.name))
    os.makedirs(cfg.output_path, exist_ok=True)
    if not dist.is_main_process():
        return cfg
    with open(os.path.join(cfg.output_path, "run.bash"), "a+") as f:
        f.write("python %s\n" % " ".join(sys.argv))
    with open(os.path.join(cfg.output_path, "options.json"), "w") as f:
        json.dump(cfg, f, indent=2, sort_keys=True)
    return cfg

