"""The eval slice's configuration as a Python dict.

`dtu_eval_slice_config()` is configs/base.yaml overlaid with
configs/test.yaml, with `precision.block_kernel: false` (the per-ray path
that the three ported kernels cover), restricted to the keys the eval render
reads. It exists so the port runs where PyYAML is not installed; a CPU test
holds it equal to what `matchnerf_tpu.config` loads from the YAML files.
"""
from __future__ import annotations

from matchnerf_tpu.utils.containers import DotDict


def dtu_eval_slice_config() -> DotDict:
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
            "block_kernel": False,
            "decoder_kernel": True,
        },
    })


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
]
