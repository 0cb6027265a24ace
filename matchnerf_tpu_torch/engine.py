"""The training iteration (counterpart of the `Coach` training loop in
matchnerf_tpu/engine.py:399-500): optimizer set-up, the per-pose route of
the cond query, one step per batch, the iteration count and the loss read
back only every `freq.scalar` steps.

Not ported yet: datasets and loaders, checkpoints, validation and test
renders inside training, the preemption handler and the training CLI.
"""
from __future__ import annotations

import logging
import math
from typing import Dict, Optional

import numpy as np
import torch

from .models.matchnerf import MatchNeRF
from .ops.block_cosine_prior import takes_f32
from .renderer import Renderer, extract_poses
from .train_step import build_optimizer, make_train_step
from .utils.containers import effective_precision

log = logging.getLogger(__name__)


class Coach:
    """Trains one model on one device (the card unless the caller asks for
    the CPU). kernel=False runs every kernel's plain version.

    `setup_optimizer(total_steps)` builds the two-group AdamW and the step
    for the recipe's shape (data_train.img_wh, nerf.rand_rays_train);
    `train_iteration(batch)` takes one step on a numpy batch (images
    [1,V+1,H,W,3], extrinsics, intrinsics, near_fars as `Renderer.forward`
    takes them) and returns {'render', 'all'}: device scalars, or floats
    (checked finite) on every `freq.scalar`-th iteration or with
    sync_loss_every_step."""

    def __init__(self, cfg, model: MatchNeRF, device="cuda", kernel: bool = True):
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.renderer = Renderer(cfg, model, device, kernel)
        self.kernel = kernel
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(cfg.get("seed") or 0))
        self.it = 0
        self.opt = None
        self.step = None
        self.last_route: Optional[tuple] = None
        self._route_cache: Dict[bytes, Optional[tuple]] = {}

    def setup_optimizer(self, total_steps: int):
        cfg = self.cfg
        W, H = cfg.data_train.img_wh
        n_rays = int(cfg.nerf.rand_rays_train) // max(int(cfg.batch_size), 1)
        self.train_hw = (int(H), int(W), n_rays)
        self.opt = build_optimizer(cfg, self.model, total_steps)
        self.step = make_train_step(cfg, self.model, self.opt, int(H), int(W), n_rays,
                                    kernel=self.kernel, generator=self.generator)
        log.info("%s optimizer, lr_enc=%s, lr_dec=%s, %d total steps",
                 cfg.optim.algo.type, cfg.optim.lr_enc, cfg.optim.lr_dec, total_steps)

    def batch_tensors(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The numpy batch on the device, with the target's c2w."""
        t = self.renderer.tensor
        return {"images": t(batch["images"]), "extrinsics": t(batch["extrinsics"]),
                "intrinsics": t(batch["intrinsics"]), "near_fars": t(batch["near_fars"]),
                "tgt_c2w": t(self.renderer.prepare_target(
                    np.asarray(batch["extrinsics"])[:, -1, :3, :]))}

    def train_route(self, batch: Dict) -> Optional[tuple]:
        """Per-scale block-union buckets of the batch's pose, cached by pose
        bytes (engine.py:416 `_train_banded_kt`): only with
        nerf.train_ray_patches and precision.block_kernel and B == 1; a scale
        takes D' where `Renderer.pose_prep` gives a bucket that D' takes on
        f32 tables, B' elsewhere (None everywhere: B' at every scale, which
        reads its taps directly and needs no per-ray bucket)."""
        cfg = self.cfg
        prec = effective_precision(cfg)
        get = prec.get if hasattr(prec, "get") else (lambda *_: None)
        patches = bool(cfg.nerf.get("train_ray_patches", False))
        if not (get("banded_kernel") and get("block_kernel") and patches
                and int(cfg.batch_size) == 1):
            return None
        key = b"".join(np.asarray(batch[k], np.float32).tobytes()
                       for k in ("extrinsics", "intrinsics", "near_fars"))
        if key not in self._route_cache:
            H, W, _ = self.train_hw
            up = int(cfg.encoder.upsample_factor)
            scale_hws = [(H // 8, W // 8), (H // 8 * up, W // 8 * up)]
            block_ut, _ = self.renderer.pose_prep(extract_poses(batch), scale_hws, H, W)
            route = None
            if block_ut is not None:
                S = int(cfg.nerf.sample_intvs)
                groups = cfg.encoder.cos_n_group
                groups = [groups] * len(scale_hws) if isinstance(groups, int) else list(groups)
                route = tuple(ut if ut is not None and takes_f32(ut, S, g) else None
                              for ut, g in zip(block_ut, groups))
                if all(u is None for u in route):
                    route = None
            log.info("training route: pose_prep block_ut %s -> per-scale %s "
                     "(None: Kernel B')", block_ut, route)
            self._route_cache[key] = route
        return self._route_cache[key]

    def train_iteration(self, batch: Dict) -> Dict:
        if self.step is None:
            raise RuntimeError("call setup_optimizer first")
        route = self.train_route(batch)
        self.last_route = route
        loss = self.step(self.batch_tensors(batch), block_ut=route)
        self.it += 1
        freq = self.cfg.get("freq") or {}
        scalar = int(freq.get("scalar", 0) or 0)
        if bool(self.cfg.get("sync_loss_every_step", False)) or (
                scalar > 0 and self.it % scalar == 0):
            loss = {k: float(v) for k, v in loss.items()}
            for k, v in loss.items():
                if not math.isfinite(v):
                    raise FloatingPointError(f"loss {k} is {v} at iteration {self.it}")
        return loss
