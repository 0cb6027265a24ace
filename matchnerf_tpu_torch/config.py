"""The eval render's, the demo entry's and the training step's
configurations as Python dicts, and the entry's `--key=value` overrides.

`dtu_eval_config()` is configs/base.yaml overlaid with configs/test.yaml as
shipped (`precision.block_kernel` and `precision.color_block_kernel` on),
restricted to the keys the eval render reads. `dtu_eval_per_ray_config()`
is the same with `precision.block_kernel: false`: the per-ray cosine-prior
path. `dtu_train_config()` is configs/base.yaml overlaid with
configs/train.yaml (iid rays), restricted to the keys the training step
reads; `dtu_train_fast_config()` adds configs/train_fast.yaml (8-pixel ray
strips, the block route). They exist so the port runs where PyYAML is not
installed; a CPU test holds them equal to what `matchnerf_tpu.config` loads
from the YAML files. `encoder.attention_backend` and
`encoder.conv_data_format` are TPU backend and layout knobs: carried as
keys, they change nothing here. `demo_own_config()` is configs/base.yaml +
configs/test.yaml + configs/demo_own.yaml (the IBR decoder variant on the
in-repo COLMAP printer scene, video mode), restricted to the keys the
entry (`matchnerf_tpu_torch/test.py`) reads; `precision.fused_cosine` stays
as base.yaml sets it (off) and the entry's override turns it on.
`test_video_own_config()` adds configs/test_video_own.yaml (S = 256,
5012-ray slices, 960x640). `precision.decoder_matmul_dtype`, absent from
the YAML files, reads as float32; bf16 picks Kernel C's bf16 route.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

from .utils.containers import DotDict

log = logging.getLogger(__name__)


def dtu_eval_config() -> DotDict:
    return DotDict({
        "n_src_views": 3,
        "batch_size": 1,
        "encoder": {
            "attn_splits_list": [2],
            "cos_n_group": [2, 8],
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
            "rand_rays_test": 20480,
        },
        "precision": {
            "encoder_compute_dtype": "bfloat16",
            "cond_sample_dtype": "int8",
            "color_sample_dtype": "uint8",
            "banded_kernel": True,
            "block_kernel": True,
            "decoder_kernel": True,
            "color_block_kernel": True,
        },
    })


def dtu_eval_per_ray_config() -> DotDict:
    cfg = dtu_eval_config()
    cfg.precision.block_kernel = False
    return cfg


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


def dtu_train_config() -> DotDict:
    return DotDict({
        "seed": 0,
        "n_src_views": 3,
        "batch_size": 1,
        "max_epoch": 12,
        "sync_loss_every_step": False,
        "data_train": {"img_wh": [640, 512]},
        "encoder": {
            "attn_splits_list": [2],
            "cos_n_group": [2, 8],
            "num_transformer_layers": 6,
            "feature_upsampler": "network",
            "upsample_factor": 2,
            "wo_self_attn": False,
            "feature_sample_local_radius": 0,
            "feature_sample_local_dilation": 1,
            "attention_backend": "fused",
            "conv_data_format": "NCHW",
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
            "rand_rays_train": 1024,
        },
        "precision": {
            "encoder_compute_dtype": "bfloat16",
            "decoder_compute_dtype": "bfloat16",
            "banded_kernel": True,
            "block_kernel": True,
        },
        "loss_weight": {"render": 1},
        "optim": {
            "lr_enc": 5e-5,
            "lr_dec": 5e-4,
            "clip_enc": 1.0,
            "algo": {"type": "AdamW", "weight_decay": 1e-4},
            "sched": {"type": "OneCycleLR", "pct_start": 0.05},
        },
        "freq": {"scalar": 20},
    })


def dtu_train_fast_config() -> DotDict:
    cfg = dtu_train_config()
    cfg.nerf.train_ray_patches = True
    return cfg


# every key the training step reads, as dotted paths (a key absent from a
# config reads as its default)
TRAIN_SLICE_KEYS = [
    "seed", "n_src_views", "batch_size", "max_epoch", "sync_loss_every_step",
    "data_train.img_wh",
    "encoder.attn_splits_list", "encoder.cos_n_group",
    "encoder.num_transformer_layers", "encoder.feature_upsampler",
    "encoder.upsample_factor", "encoder.wo_self_attn",
    "encoder.feature_sample_local_radius", "encoder.attention_backend",
    "encoder.conv_data_format",
    "decoder.net_width", "decoder.net_depth", "decoder.skip", "decoder.posenc",
    "decoder.raytrans_posenc", "decoder.density_maskfill", "decoder.raytrans_act",
    "nerf.legacy_coord", "nerf.wo_render_interval", "nerf.view_dep",
    "nerf.depth", "nerf.sample_intvs", "nerf.sample_stratified",
    "nerf.rand_rays_train", "nerf.train_ray_patches", "nerf.train_ray_sampler",
    "precision.encoder_compute_dtype", "precision.decoder_compute_dtype",
    "precision.banded_kernel", "precision.block_kernel", "precision.strict",
    "loss_weight.render",
    "optim.lr_enc", "optim.lr_dec", "optim.clip_enc", "optim.algo.type",
    "optim.algo.weight_decay", "optim.sched.type", "optim.sched.pct_start",
    "optim.sched.div_factor", "optim.sched.final_div_factor",
    "freq.scalar",
]


def demo_own_config() -> DotDict:
    cfg = dtu_eval_config()
    cfg.update({"name": "test_video/demo", "seed": 0,
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

CONFIGS = {"demo_own": demo_own_config, "test_video_own": test_video_own_config}


def _parse_value(text: Optional[str]):
    """A command-line value as the JAX package's YAML parse reads the common
    cases: empty -> None, true/false/null, int, float, `a,b,` -> a list
    (digit items as int), anything else a string."""
    if text is None or text == "":
        return None
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


def override_options(cfg: DotDict, over, key_stack=()) -> DotDict:
    """Merge `over` into `cfg` (config.py:87); a key the config does not
    have is added with a warning."""
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(cfg.get(key), dict):
            override_options(cfg[key], value, (*key_stack, key))
            continue
        if key not in cfg:
            log.warning('"%s" not found in the configuration, adding it',
                        ".".join((*key_stack, key)))
        cfg[key] = value
    return cfg
