"""Evaluation and video renderer (counterpart of matchnerf_tpu/renderer.py,
test and val modes).

`Renderer.forward(batch, mode="test")` encodes the source views once, builds
the sampling tables, and renders the full target image in slices of
`nerf.rand_rays_test` rays (capped at `nerf.max_rays_per_slice`, default
8192, off the CPU — renderer.py:597-602). PyTorch runs eagerly, so slices are
plain Python iterations with a ragged last slice; the JAX package's
`slices_per_dispatch` scan is not carried.

With `precision.block_kernel` (configs/test.yaml as shipped) the cond query
takes the block path: once per target pose, `pose_prep` measures over the
whole image the z-safety of the depth endpoints, the exact largest dilated
block union of each feature scale and the largest supercell union, and
picks the same per-scale route and buckets as the JAX `_pose_prep`: Kernel
D where a scale's union fits a bucket, Kernel B where it overflows, Kernel
E for the colours where their union fits, the colour gather where not. The
per-ray `kt` buckets of the JAX package are not carried (Kernel B reads its
taps directly). With `precision.fused_cosine` (read through
`effective_precision`, so `strict` turns it off) every feature scale takes
Kernel F instead (renderer.py:281-291, :337-338); the colours still follow
the pose's route. With `encoder.feature_sample_local_radius` > 0 no table is
built (renderer.py:743): the slices sample the encoder's maps and the f32
source images directly, on neither the block nor the fused route.

`forward(batch, render_video=True, render_path_mode=...)` renders a
trajectory of `nerf.video_n_frames` target poses (interpolated between the
source cameras, or an LLFF spiral) from one encode and one table build,
one `render_by_slices` per frame (renderer.py:689-757).

Several ranks (`set_ray_sharding`; renderer.py:202-247, :596-685): every
rank encodes (with parallel.shard_encoder_streams_eval, on by default and
off under precision.strict, each its share of the encoder's streams,
gathered), builds the tables and measures the pose over the whole image,
so the route is the same everywhere; each slice's R rays (R rounded up to a
multiple of the ranks, the last slice padded with the last pixel) are split
into contiguous R / n shares, each rank renders its share of every slice,
and the rgb, depth and opacity are gathered so that every rank holds the
image. The block route needs (R / n) % 8 == 0; where that fails the
per-ray route takes the pose, with the JAX package's log line.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import camera
from .models.matchnerf import (MatchNeRF, encode, local_radius, prepare_sampling_tables,
                               project_to_views, render_rays, sample_depth)
from .ops.block_cosine_prior import BLOCK_RAYS, block_union_max, bucket_ut
from .ops.supercell_color import bucket_color_ut, color_union_max
from .parallel import distributed as dist
from .parallel import mesh
from .utils.containers import effective_precision

log = logging.getLogger(__name__)

POSE_PREP_CHUNK = 8192        # rays per measurement chunk (renderer.py:505)


def cond_sample_dtype(cfg):
    """Feature-table dtype from precision.cond_sample_dtype, one name or a
    per-scale list (renderer.py:30-47): torch.int8, torch.bfloat16,
    torch.float32, or the int4 name itself ("int4", "int4pXX.X": nibble
    tables, `prepare_sampling_tables`); a list gives one entry per scale.
    A name the JAX function does not know maps to f32, as there."""
    prec = effective_precision(cfg)
    name = prec.get("cond_sample_dtype", "bfloat16") if hasattr(prec, "get") else "bfloat16"

    def one(n):
        n = str(n)
        if n in ("bf16", "bfloat16"):
            return torch.bfloat16
        if n == "int8":
            return torch.int8
        if n.startswith("int4"):
            return n
        return torch.float32

    if isinstance(name, (list, tuple)):
        return [one(n) for n in name]
    return one(name)


def color_sample_dtype(cfg):
    """uint8 colour table when precision.color_sample_dtype is uint8."""
    name = str(effective_precision(cfg).get("color_sample_dtype", "float32"))
    return torch.uint8 if name in ("u8", "uint8") else None


def fused_cosine(cfg) -> bool:
    """precision.fused_cosine: every feature scale takes Kernel F."""
    prec = effective_precision(cfg)
    return hasattr(prec, "get") and bool(prec.get("fused_cosine", False))


def block_path(cfg) -> bool:
    """precision.block_kernel: the cond query takes the block path (Kernels
    D and E, per-pose fallback to Kernel B and the colour gather;
    renderer.py:62 `banded_impl` == 'block')."""
    prec = effective_precision(cfg)
    return hasattr(prec, "get") and bool(prec.get("block_kernel", False))


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


def index_batch(tree, b: int):
    """Batch element [b:b+1] of every array leaf of a poses/tables tree;
    scalars and None pass through (renderer.py:161)."""
    if isinstance(tree, dict):
        return {k: index_batch(v, b) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(index_batch(v, b) for v in tree)
    if getattr(tree, "ndim", 0) >= 1:
        return tree[b:b + 1]
    return tree


class Renderer:
    """Eval renderer of one model on one device (the card unless the caller
    asks for the CPU).

    kernel=False renders with every kernel replaced by its plain version
    (same precision settings and the same per-pose route) — the reference
    the kernel path is held to. `last_route` is the route of the last
    rendered pose, `frame_routes` that of each frame of the last video.
    `setbg_opaque` composites every render onto a white background (the
    JAX renderer's `nerf_setbg_opaque`, which the eval entry sets for
    Blender), through Kernel C's `setbg` or the plain composite."""

    def __init__(self, cfg, model: MatchNeRF, device="cuda", kernel: bool = True):
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.kernel = kernel
        self.setbg_opaque = False
        self.last_route: Optional[Dict] = None
        self.frame_routes: List[Dict] = []
        self.ray_shards = 1

    def set_ray_sharding(self, on: bool = True):
        """Split every render's rays (and, as configured, the encoder's
        streams) over the ranks of the process group (the JAX `set_mesh`)."""
        self.ray_shards = dist.process_count() if on else 1

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def shard_streams(self) -> bool:
        """parallel.shard_encoder_streams_eval under ray sharding, never
        with precision.strict (renderer.py:227-240)."""
        par = self.cfg.get("parallel") or {}
        strict = bool(effective_precision(self.cfg).get("strict", False))
        return (self.ray_shards > 1 and bool(par.get("shard_encoder_streams_eval", False))
                and not strict)

    @torch.no_grad()
    def encode(self, ref_images: torch.Tensor) -> List[torch.Tensor]:
        return encode(self.model, self.cfg, ref_images, kernel=self.kernel,
                      shard_streams=self.shard_streams())

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

    def _pose_tensors(self, poses):
        """(tgt_intr [1,3,3], tgt c2w [1,3,4], tgt near/far [1,2], ref w2c
        [1,V,3,4], ref intrinsics, ref near/fars) on the device."""
        tgt = poses["tgt"]
        return (self.tensor(tgt["intrinsics"]),
                self.tensor(self.prepare_target(np.asarray(tgt["extrinsics"]))),
                self.tensor(np.asarray(tgt["near_fars"]).reshape(-1, 2)),
                self.tensor(np.asarray(poses["ref"]["extrinsics"])[..., :3, :]),
                self.tensor(poses["ref"]["intrinsics"]),
                self.tensor(poses["ref"]["near_fars"]))

    @torch.no_grad()
    def pose_prep(self, poses, scale_hws, img_h: int, img_w: int,
                  measure_color: bool = False):
        """The block path's route for one target pose (B == 1), measured
        over the whole image (renderer.py:396 `_get_pose_prep_fn` and :492
        `_pose_prep`): -> (block_ut, color_ut).

        block_ut is None when the pose is not z-safe (a depth endpoint at or
        behind a source camera) or no scale's union fits a bucket; else a
        tuple with, per scale of `scale_hws` ((h, w) per feature scale, or
        None for a scale that cannot take Kernel D: int4 tables), the
        bucket of the exact largest dilated 8-ray block union, or None
        where it overflows or was not measured (that scale takes Kernel
        B). color_ut is the
        bucket of the largest supercell union (None: overflow, not z-safe,
        or not measured). The 8-ray blocks are the absolute 8-pixel
        partition of the image, measured in chunks of 8192 rays with the
        tail padded by the last pixel, as the render slices pad it."""
        cfg = self.cfg
        S = int(cfg.nerf.sample_intvs)
        n_pix = img_h * img_w
        R = POSE_PREP_CHUNK
        n_chunks = (n_pix + R - 1) // R
        grid = camera.pixel_grid(img_h, img_w, legacy=cfg.nerf.legacy_coord,
                                 device=self.device)
        idx = torch.clamp_max(torch.arange(n_chunks * R, device=self.device), n_pix - 1)
        pix_all = grid[idx]
        tgt_intr, c2w, tgt_nf, ref_w2c, ref_intr, ref_nf = self._pose_tensors(poses)

        # z-safety at the sample endpoints: z is affine in depth, so z > 0 at
        # both ends means z > 0 along the whole ray (monotone projection)
        center, ray = camera.get_center_and_ray(pix_all[None], tgt_intr, c2w)
        depth = sample_depth(cfg, tgt_nf, 1, pix_all.shape[0])
        ends = torch.cat([depth[:, :, :1], depth[:, :, S - 1:S]], dim=2)
        ep = camera.get_3d_points_from_depth(center, ray, ends,
                                             multi_samples=True).reshape(-1, 3)
        zmin = torch.stack([(ep @ ref_w2c[0, v, :, :3].T + ref_w2c[0, v, :, 3])[:, 2].min()
                            for v in range(ref_w2c.shape[1])]).min()

        # per chunk: the exact largest unions, kept on the device (one host
        # sync per pose)
        hws = [hw for hw in scale_hws if hw is not None]
        sizes = None
        for c in range(n_chunks if hws or measure_color else 0):
            pix = pix_all[c * R:(c + 1) * R][None]
            center, ray = camera.get_center_and_ray(pix, tgt_intr, c2w)
            pts = camera.get_3d_points_from_depth(center, ray,
                                                  sample_depth(cfg, tgt_nf, 1, R),
                                                  multi_samples=True)
            grids = (project_to_views(pts, ref_w2c, ref_intr, ref_nf, img_h, img_w)
                     [:, 0, ..., :2] * 2.0 - 1.0)                     # [V,R,S,2]
            now = [block_union_max(grids, h, w) for (h, w) in hws]
            if measure_color:
                now.append(color_union_max(grids, img_h, img_w))
            now = torch.stack(now)
            sizes = now if sizes is None else torch.maximum(sizes, now)
        sizes = [] if sizes is None else sizes.tolist()
        if not float(zmin) > 1e-6:
            return None, None
        color_ut = bucket_color_ut(sizes[-1]) if measure_color else None
        measured = iter(sizes[:len(hws)])
        uts = tuple(None if hw is None else bucket_ut(next(measured)) for hw in scale_hws)
        return (None if all(u is None for u in uts) else uts), color_ut

    @torch.no_grad()
    def render_by_slices(self, poses, tables: dict, img_h: int, img_w: int,
                         timings: Optional[Dict] = None) -> Dict:
        """Full image in ray slices -> dict of [B, H*W, *] tensors. With a
        `timings` dict, the seconds of the block path's pose_prep (device
        synchronised) are added under "pose_prep"."""
        cfg = self.cfg
        B = tables["colors"].shape[0]
        # the local-radius route builds no feature table to take the block path
        block = block_path(cfg) and local_radius(cfg) == 0
        if B > 1 and block:
            # the block path needs one pose per render: split the batch
            # (renderer.py:582-596); each element renders as a B == 1 call
            per = [self.render_by_slices(index_batch(poses, b), index_batch(tables, b),
                                         img_h, img_w, timings) for b in range(B)]
            return {k: torch.cat([o[k] for o in per], dim=0) for k in per[0]}
        R = self.rays_per_slice(B)
        n = self.ray_shards
        if n > 1:
            R = max(-(-R // n) * n, n)
        share = R // n
        block_ut = color_ut = None
        if block:
            if share % BLOCK_RAYS == 0:
                # slices start at multiples of R, so their 8-ray blocks are
                # the absolute 8-pixel partition that pose_prep measured
                # an int4 scale never takes Kernel D: its union is not measured
                scale_hws = [None if v.dtype == torch.uint8 else (v.shape[2], v.shape[3])
                             for v in tables["view_feats"]]
                t0 = time.perf_counter()
                block_ut, color_ut = self.pose_prep(
                    poses, scale_hws, img_h, img_w,
                    measure_color=tables.get("colors_sc") is not None)
                if timings is not None:      # pose_prep ends in a host sync
                    timings["pose_prep"] = (timings.get("pose_prep", 0.0)
                                            + time.perf_counter() - t0)
                log.info("block path route: block_ut %s (None: Kernel B), "
                         "color_ut %s (None: colour gather)", block_ut, color_ut)
            elif n > 1:
                log.info("block kernel unavailable (ray shard %d not %d-aligned); falling "
                         "back to the per-ray banded/direct path", share, BLOCK_RAYS)
            else:
                log.info("block kernels unavailable (ray slice %d not %d-aligned); "
                         "Kernel B and the colour gather take the pose", R, BLOCK_RAYS)
        self.last_route = {"block_ut": block_ut, "color_ut": color_ut}
        grid = camera.pixel_grid(img_h, img_w, legacy=cfg.nerf.legacy_coord,
                                 device=self.device)
        tgt_intr, c2w, tgt_nf, ref_w2c, ref_intr, ref_nf = self._pose_tensors(poses)
        fused = fused_cosine(cfg)
        n_pix = img_h * img_w
        if n > 1:
            # every slice padded to R rays with the last pixel; this rank's
            # contiguous share of each
            n_slices = -(-n_pix // R)
            idx = torch.clamp_max(torch.arange(n_slices * R, device=self.device), n_pix - 1)
            rank = dist.process_index()
            starts = [s * R + rank * share for s in range(n_slices)]
            pixels = [grid[idx[s0:s0 + share]] for s0 in starts]
        else:
            pixels = [grid[s0:s0 + R] for s0 in range(0, n_pix, R)]
        outs: Dict[str, list] = {}
        for pix in pixels:
            ret = render_rays(self.model, cfg, pix[None].expand(B, -1, 2), tgt_intr, c2w,
                              tgt_nf, ref_w2c, ref_intr, ref_nf, tables, img_h, img_w,
                              kernel=self.kernel, block_ut=block_ut,
                              color_ut=color_ut, fused_cosine=fused,
                              setbg_opaque=self.setbg_opaque)
            for k, v in ret.items():
                outs.setdefault(k, []).append(v)
        if n == 1:
            return {k: torch.cat(v, dim=1) for k, v in outs.items()}
        return self._gather_shares(outs, n, len(pixels), share, n_pix)

    @staticmethod
    def _gather_shares(outs: Dict[str, list], n: int, n_slices: int, share: int,
                       n_pix: int) -> Dict[str, torch.Tensor]:
        """Every rank's [B, share, c] outputs of every slice -> [B, n_pix, c]
        on every rank (one gather of all keys; slice-major, rank order)."""
        keys = list(outs)
        widths = [outs[k][0].shape[-1] for k in keys]
        local = torch.stack([torch.cat([outs[k][s] for k in keys], dim=-1)
                             for s in range(n_slices)])          # [slices, B, share, c]
        full = mesh.gather_rows(local[None], n)                  # [n, slices, B, share, c]
        B, c = local.shape[1], local.shape[-1]
        full = full.permute(2, 1, 0, 3, 4).reshape(B, n_slices * n * share, c)[:, :n_pix]
        return {k: v.contiguous() for k, v in zip(keys, torch.split(full, widths, dim=-1))}

    def get_video_rendering_path(self, poses, mode: str, n_frames: int,
                                 batch: Optional[Dict] = None) -> List[Dict]:
        """Per-frame target-pose dicts (extrinsics [B,3,4] w2c, the target's
        intrinsics and near/fars) along the interpolated path between the
        source cameras or, with mode "spiral", the LLFF spiral around
        `batch["c2ws_all"]` (renderer.py:689). Host-side numpy."""
        src_extr = np.asarray(poses["ref"]["extrinsics"])          # [B,V,3,4]
        per_batch_w2cs = []
        for b in range(src_extr.shape[0]):
            if mode == "interpolate":
                c2ws = camera.pose_inverse_legacy_np(src_extr[b])
                sq = np.repeat(np.eye(4, dtype=np.float32)[None], len(c2ws), 0)
                sq[:, :3, :] = c2ws
                path = camera.get_interpolate_render_path(sq, n_frames)
            elif mode == "spiral":
                if batch is None or "c2ws_all" not in batch:
                    raise ValueError("the spiral path needs batch['c2ws_all']")
                near_far = np.asarray(poses["tgt"]["near_fars"][b]).tolist()
                rads_scale = float(self.cfg.nerf.get("video_rads_scale", 0.1))
                path = camera.get_spiral_render_path(np.asarray(batch["c2ws_all"][b]),
                                                     near_far, rads_scale=rads_scale,
                                                     n_frames=n_frames)
            else:
                raise ValueError(f"Unknown video rendering path mode {mode}")
            per_batch_w2cs.append(np.linalg.inv(path)[:, :3].astype(np.float32))
        w2cs_all = np.stack(per_batch_w2cs)                         # [B,n,3,4]
        return [{"extrinsics": w2cs_all[:, f],
                 "intrinsics": np.asarray(poses["tgt"]["intrinsics"]),
                 "near_fars": np.asarray(poses["tgt"]["near_fars"])}
                for f in range(n_frames)]

    @torch.no_grad()
    def forward(self, batch: Dict, mode: str = "test", render_video: bool = False,
                render_path_mode: str = "interpolate",
                timings: Optional[Dict] = None) -> Dict:
        """Encode once, build the tables, render the target image
        (renderer.py:728). Modes "test" and "val" render alike, as in the
        JAX package: the whole image in slices of nerf.rand_rays_test rays. batch: numpy images [B,V+1,H,W,3],
        extrinsics [B,V+1,3|4,4], intrinsics [B,V+1,3,3], near_fars
        [B,V+1,2]. Returns rgb [B,H*W,3], depth and opacity [B,H*W,1].
        With render_video, the `nerf.video_n_frames` frames of the
        `render_path_mode` trajectory instead, concatenated frame-major:
        [n_frames*B, H*W, *].

        timings: if a dict is given, the device is synchronised after each
        phase and its wall seconds are stored under encode/tables/render;
        the block path's pose_prep seconds, part of render, also stand
        under pose_prep."""
        if mode not in ("test", "val"):
            raise NotImplementedError(f"mode {mode!r}: the port renders eval images only "
                                      "(training rays go through train_step)")
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
        poses = extract_poses(batch)
        if render_video:
            frames = self.get_video_rendering_path(
                poses, render_path_mode, int(self.cfg.nerf.video_n_frames), batch)
            self.frame_routes = []
            outs: Dict[str, list] = {}
            for fp in frames:
                ret = self.render_by_slices({"tgt": fp, "ref": poses["ref"]}, tables,
                                            H, W, timings)
                self.frame_routes.append(self.last_route)
                for k, v in ret.items():
                    outs.setdefault(k, []).append(v)
            out = {k: torch.cat(v, dim=0) for k, v in outs.items()}
        else:
            out = self.render_by_slices(poses, tables, H, W, timings)
        mark("render", t0)
        return out
