"""The eval render's and the training step's configurations as Python dicts.

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
keys, they change nothing here.
"""
from __future__ import annotations

from .utils.containers import DotDict


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
    "precision.color_block_kernel",
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
