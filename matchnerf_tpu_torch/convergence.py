"""The convergence run: the training recipe learns a small scene
(counterpart of tools/convergence_tpu.py and tests/test_convergence.py).

    python -m matchnerf_tpu_torch.convergence [--steps 200] [--sample_intvs 32]
        [--recipe tiny|train|train_fast] [--plain] [--cpu] [--seed 0]

A model of the JAX tool's size (2 transformer layers, 128 features, decoder
128 x 6) overfits `data/synth.py::make_scene_views` at 32x48 (3 source
views and a target) from 256 random rays a step, with the whole optimizer
stack (two AdamW groups, OneCycle, the encoder's clip), then renders the
target view whole in 1024-ray slices and scores it; the JAX tool calls it
the held-out view, though the steps train on its rays. Every step is
`engine.Coach.train_iteration`, so the route, the draws and the
determinism settings are the training entry's.

Recipes:
- tiny: the JAX tool's config (no precision block: f32 encoder and
  decoder, the plain matching prior as in the JAX package; Kernel A' is
  the only kernel a step runs);
- train: configs/train.yaml's precision block on top (bf16 encoder, the
  banded and block kernels, bf16 decoder compute): A' and B' every step;
- train_fast: configs/train_fast.yaml's 8-pixel ray strips as well: D' at
  each scale that `Coach.train_route` gives a bucket, B' elsewhere.

It runs on the card unless given --cpu, and raises without one; --plain
runs every kernel's plain version (`Coach(kernel=False)`). The weights
come from --seed, the step's draws from --seed + 1 (the JAX tool's
PRNGKey(0) and PRNGKey(1)). The last line reads
`CONVERGENCE: held-out view PSNR <x> dB after <n> steps (<recipe>,
kernel|plain, <device>)`.
"""
from __future__ import annotations

import argparse
import copy
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import kernels
from .config import dtu_train_config, dtu_train_fast_config
from .data.synth import make_scene_views
from .engine import Coach
from .models.matchnerf import MatchNeRF, init_matchnerf
from .utils.containers import DotDict

H, W = 32, 48
N_RAYS = 256                  # training rays a step
TEST_RAYS = 1024              # rays a slice of the target view's render
RECIPES = ("tiny", "train", "train_fast")
LOG_EVERY = 50


def tiny_config(sample_intvs: int = 32, n_layers: int = 2) -> DotDict:
    """The JAX tool's config: `__graft_entry__._tiny_cfg(n_layers,
    sample_intvs)` with 256 training rays, 1024-ray render slices and the
    tool's optimizer (tools/convergence_tpu.py:49-53). Its
    `encoder.attention_backend = "xla"` is a TPU knob and is left out."""
    return DotDict({
        "n_src_views": 3,
        "batch_size": 1,
        "seed": 1,
        "encoder": {
            "attn_splits_list": [2], "cos_n_group": [2, 8],
            "num_transformer_layers": n_layers, "feature_upsampler": "network",
            "upsample_factor": 2, "wo_self_attn": False,
            "feature_sample_local_radius": 0, "feature_sample_local_dilation": 1,
            "pretrain_weight": None,
        },
        "decoder": {
            "net_width": 128, "net_depth": 6, "skip": [4],
            "posenc": {"L_3D": 10, "L_view": 0},
            "raytrans_posenc": False, "density_maskfill": False,
            "raytrans_act": "ReLU",
        },
        "nerf": {
            "legacy_coord": True, "wo_render_interval": True, "view_dep": True,
            "depth": {"param": "metric"}, "sample_intvs": sample_intvs,
            "sample_stratified": True, "density_noise_reg": None,
            "rand_rays_train": N_RAYS, "rand_rays_test": TEST_RAYS,
        },
        "loss_weight": {"render": 1},
        "optim": {
            "lr_enc": 2e-4, "lr_dec": 5e-3, "clip_enc": 1.0,
            "algo": {"type": "AdamW", "weight_decay": 0.0},
            "sched": {"type": "OneCycleLR", "pct_start": 0.1},
        },
        "data_train": {"img_wh": [W, H]},
    })


def recipe_config(recipe: str, sample_intvs: int = 32, n_layers: int = 2) -> DotDict:
    """`tiny_config` with the recipe's keys: train.yaml's precision block
    (train), and train_fast.yaml's ray strips (train_fast)."""
    if recipe not in RECIPES:
        raise ValueError(f"recipe {recipe!r}: one of {RECIPES}")
    cfg = tiny_config(sample_intvs, n_layers)
    if recipe != "tiny":
        cfg.precision = copy.deepcopy(dtu_train_config().precision)
    if recipe == "train_fast":
        fast = dtu_train_fast_config()
        cfg.nerf.train_ray_patches = fast.nerf.train_ray_patches
        cfg.precision.block_kernel = fast.precision.block_kernel
    return cfg


def scene_batch(views: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """make_scene_views' 4 views as one training batch: views 0-2 the
    sources, view 3 the target."""
    return {"images": views["images"][None], "extrinsics": views["w2cs"][None],
            "intrinsics": views["intrinsics"][None], "near_fars": views["near_fars"][None]}


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(-10.0 * np.log10(np.mean((pred.astype(np.float64) - gt) ** 2)))


def run(cfg, steps: int, device="cuda", kernel: bool = True, seed: int = 0,
        model: Optional[MatchNeRF] = None,
        draws: Optional[Callable[[int], tuple]] = None,
        log: Optional[Callable[[str], None]] = print) -> Dict:
    """`steps` steps of `Coach.train_iteration` on the scene, then the
    target view rendered whole by `coach.renderer`. The weights are
    `model`'s, else seeded from `seed`; the draws come from the Coach's
    generator, seeded with seed + 1, unless `draws(i)` gives step i's
    (ray_idx, depth_rand). Each step's kernel counts are recorded by
    `kernels.record_steps`; the counts are set to 0 before the render and
    read after it. Returns the per-step losses and {launches, plain
    versions on CUDA, route} (`Coach.train_route`),
    the render's counts and route, the PSNR and the seconds."""
    cfg = DotDict(cfg)
    cfg.seed = seed + 1
    say = log or (lambda msg: None)
    views = make_scene_views(W, H)
    batch = scene_batch(views)
    if model is None:
        model = init_matchnerf(cfg, torch.Generator().manual_seed(seed))
    model = model.to(device)
    coach = Coach(cfg, model, device, kernel=kernel)
    coach.setup_optimizer(steps)
    counters = kernels.counters()
    per_step = kernels.record_steps(coach)
    losses = []
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for it in range(steps):
        ray_idx, depth_rand = draws(it) if draws is not None else (None, None)
        loss = coach.train_iteration(batch, ray_idx, depth_rand)
        losses.append(loss["all"])
        if it == 0 or (it + 1) % LOG_EVERY == 0:
            say(f"# step {it + 1:4d}: loss {float(loss['all']):.5f}")
    sync()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    for c in counters.values():
        c.reset()
    with torch.no_grad():
        out = coach.renderer.forward(batch, mode="test")
    rgb = out["rgb"][0].float().cpu().numpy().reshape(H, W, 3)
    render = kernels.read(counters)
    result = {"steps": steps, "losses": losses, "wall_s": wall, "per_step": per_step,
              "render": render,
              "render_route": coach.renderer.last_route,
              "psnr": psnr(rgb, views["images"][-1]), "rgb": rgb,
              "launches": {k: sum(s["launches"][k] for s in per_step) for k in counters},
              "plain_on_cuda": {k: sum(s["plain_on_cuda"][k] for s in per_step)
                                for k in counters}}
    say(f"# {steps} steps in {wall:.1f} s wall ({steps / wall:.2f} steps/s); routes "
        f"{sorted({str(s['route']) for s in per_step})} (None: Kernel B' at both scales, "
        "or no prior kernel)")
    say("# launches in the steps: " + ", ".join(
        f"{k} {v}" for k, v in result["launches"].items() if v) + "; in the render: "
        + ", ".join(f"{k} {v}" for k, v in render["launches"].items() if v))
    plain = {k: v for k, v in result["plain_on_cuda"].items() if v}
    if plain:
        say(f"# plain versions on CUDA in the steps: {plain}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--sample_intvs", type=int, default=32)
    ap.add_argument("--recipe", choices=RECIPES, default="tiny")
    ap.add_argument("--plain", action="store_true",
                    help="every kernel's plain version (Coach(kernel=False))")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cpu:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        raise SystemExit("convergence: no CUDA device (give --cpu to run on the CPU)")
    cfg = recipe_config(args.recipe, args.sample_intvs)
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    print(f"# device={name} recipe={args.recipe} route={'plain' if args.plain else 'kernel'} "
          f"steps={args.steps} S={args.sample_intvs} seed={args.seed}")
    res = run(cfg, args.steps, device, kernel=not args.plain, seed=args.seed)
    print(f"CONVERGENCE: held-out view PSNR {res['psnr']:.2f} dB after {args.steps} steps "
          f"({args.recipe}, {'plain' if args.plain else 'kernel'}, {name})")
    return res


if __name__ == "__main__":
    main()
