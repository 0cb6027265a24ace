"""Evaluation renderer (counterpart of matchnerf_tpu/renderer.py, test mode).

`Renderer.forward(batch, mode="test")` encodes the source views once, builds
the sampling tables, and renders the full target image in slices of
`nerf.rand_rays_test` rays (capped at `nerf.max_rays_per_slice`, default
8192, off the CPU — renderer.py:597-602). PyTorch runs eagerly, so slices are
plain Python iterations with a ragged last slice; the JAX package's
`slices_per_dispatch` scan and its per-pose `kt`/`ut` bucket machinery
(dispatch and gather savings on the TPU) are not carried.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from matchnerf_tpu.utils.containers import effective_precision

from . import camera
from .models.matchnerf import (MatchNeRF, encode, prepare_sampling_tables,
                               render_rays)


def cond_sample_dtype(cfg):
    """Feature-table dtype from precision.cond_sample_dtype (int8, bf16, f32)."""
    name = str(effective_precision(cfg).get("cond_sample_dtype", "bfloat16"))
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    if name == "int8":
        return torch.int8
    if name.startswith("int4"):
        raise NotImplementedError("int4 sampling tables are not ported")
    return torch.float32


def color_sample_dtype(cfg):
    """uint8 colour table when precision.color_sample_dtype is uint8."""
    name = str(effective_precision(cfg).get("color_sample_dtype", "float32"))
    return torch.uint8 if name in ("u8", "uint8") else None


def extract_poses(batch: Dict) -> Dict:
    """Split the (V+1)-view batch into target (last) and reference poses
    (renderer.py:175). Host-side numpy."""
    return {
        "tgt": {"extrinsics": batch["extrinsics"][:, -1, :3, :],
                "intrinsics": batch["intrinsics"][:, -1],
                "near_fars": batch["near_fars"][:, -1]},
        "ref": {"extrinsics": batch["extrinsics"][:, :-1, :3, :],
                "intrinsics": batch["intrinsics"][:, :-1],
                "near_fars": batch["near_fars"][:, :-1]},
    }


class Renderer:
    """Eval renderer of one model on one device.

    kernel=False renders with every kernel replaced by its plain version
    (same precision settings) — the reference the kernel path is held to."""

    def __init__(self, cfg, model: MatchNeRF, device, kernel: bool = True):
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.kernel = kernel

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    @torch.no_grad()
    def encode(self, ref_images: torch.Tensor) -> List[torch.Tensor]:
        return encode(self.model, self.cfg, ref_images, kernel=self.kernel)

    @torch.no_grad()
    def build_tables(self, ref_images: torch.Tensor, pair_feats) -> dict:
        return prepare_sampling_tables(self.cfg, pair_feats, ref_images,
                                       feat_dtype=cond_sample_dtype(self.cfg),
                                       color_dtype=color_sample_dtype(self.cfg))

    def prepare_target(self, tgt_extr: np.ndarray) -> np.ndarray:
        """Target c2w, with the legacy float64 inverse when configured."""
        if self.cfg.nerf.legacy_coord:
            return camera.pose_inverse_legacy_np(tgt_extr)
        return camera.pose_inverse(torch.as_tensor(np.asarray(tgt_extr))).numpy()

    def rays_per_slice(self, batch_size: int) -> int:
        R = int(self.cfg.nerf.rand_rays_test) // max(batch_size, 1)
        cap = self.cfg.nerf.get("max_rays_per_slice", 8192)
        if cap and self.device.type != "cpu":
            R = min(R, int(cap))
        return R

    @torch.no_grad()
    def render_by_slices(self, poses, tables: dict, img_h: int, img_w: int) -> Dict:
        """Full image in ray slices -> dict of [B, H*W, *] tensors."""
        cfg = self.cfg
        B = tables["colors"].shape[0]
        R = self.rays_per_slice(B)
        grid = camera.pixel_grid(img_h, img_w, legacy=cfg.nerf.legacy_coord,
                                 device=self.device)
        tgt = poses["tgt"]
        c2w = self.tensor(self.prepare_target(np.asarray(tgt["extrinsics"])))
        tgt_intr = self.tensor(tgt["intrinsics"])
        tgt_nf = self.tensor(tgt["near_fars"])
        ref_w2c = self.tensor(np.asarray(poses["ref"]["extrinsics"])[..., :3, :])
        ref_intr = self.tensor(poses["ref"]["intrinsics"])
        ref_nf = self.tensor(poses["ref"]["near_fars"])
        outs: Dict[str, list] = {}
        for s0 in range(0, img_h * img_w, R):
            pix = grid[s0:s0 + R][None].expand(B, -1, 2)
            ret = render_rays(self.model, cfg, pix, tgt_intr, c2w, tgt_nf,
                              ref_w2c, ref_intr, ref_nf, tables, img_h, img_w,
                              kernel=self.kernel)
            for k, v in ret.items():
                outs.setdefault(k, []).append(v)
        return {k: torch.cat(v, dim=1) for k, v in outs.items()}

    @torch.no_grad()
    def forward(self, batch: Dict, mode: str = "test",
                timings: Optional[Dict] = None) -> Dict:
        """Encode once, build the tables, render the target image
        (renderer.py:728, mode "test"). batch: numpy images [B,V+1,H,W,3],
        extrinsics [B,V+1,3|4,4], intrinsics [B,V+1,3,3], near_fars
        [B,V+1,2]. Returns rgb [B,H*W,3], depth and opacity [B,H*W,1].

        timings: if a dict is given, the device is synchronised after each
        phase and its wall seconds are stored under encode/tables/render."""
        if mode != "test":
            raise NotImplementedError(f"mode {mode!r}: the port renders eval images only")
        V = self.cfg.n_src_views
        images = np.asarray(batch["images"])
        H, W = images.shape[2:4]

        def mark(name=None, t0=None):
            if timings is None:
                return None
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            if name is not None:
                timings[name] = t1 - t0
            return t1

        t0 = mark()
        ref_images = self.tensor(images[:, :V])
        pair_feats = self.encode(ref_images)
        t0 = mark("encode", t0)
        tables = self.build_tables(ref_images, pair_feats)
        t0 = mark("tables", t0)
        out = self.render_by_slices(extract_poses(batch), tables, H, W)
        mark("render", t0)
        return out
