"""The orchestrator (counterpart of `Coach` in matchnerf_tpu/engine.py):
the eval and video entry and the training iteration.

Eval (engine.py:81-214, :544-684): `load_dataset(["test"])` for the COLMAP
scenes, `build_networks` (weights from the config's seed),
`restore_checkpoint_if_needed` (a reference `.pth`), `test_model` (images
and PSNR / SSIM / LPIPS per view, summed up per scene and dataset) and
`test_model_video` (a trajectory per batch, written as video), with the JAX
package's output names.

Training (engine.py:399-500): optimizer set-up, the per-pose route of the
cond query, one step per batch, the iteration count and the loss read back
only every `freq.scalar` steps.

Not ported yet: the DTU, LLFF, Blender and T&T loaders, checkpoints of the
port's own training, validation inside training, the preemption handler
and the training CLI.
"""
from __future__ import annotations

import logging
import math
import os
import re
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from .data.colmap import DATASETS
from .data.loader import DataLoader
from .metrics import EvalTools, summarize_metrics
from .models.matchnerf import MatchNeRF, init_matchnerf
from .ops.block_cosine_prior import takes_f32
from .renderer import Renderer, extract_poses
from .train_step import build_optimizer, make_train_step
from .utils.containers import effective_precision
from .utils.visualize import save_image, visualize_depth, write_gif, write_video

log = logging.getLogger(__name__)


class Coach:
    """Evaluates or trains one model on one device (the card unless the
    caller asks for the CPU). kernel=False runs every kernel's plain
    version. `model` may be None until `build_networks`.

    `setup_optimizer(total_steps)` builds the two-group AdamW and the step
    for the recipe's shape (data_train.img_wh, nerf.rand_rays_train);
    `train_iteration(batch)` takes one step on a numpy batch (images
    [1,V+1,H,W,3], extrinsics, intrinsics, near_fars as `Renderer.forward`
    takes them) and returns {'render', 'all'}: device scalars, or floats
    (checked finite) on every `freq.scalar`-th iteration or with
    sync_loss_every_step."""

    def __init__(self, cfg, model: Optional[MatchNeRF] = None, device="cuda",
                 kernel: bool = True):
        self.cfg = cfg
        self.model = model
        self.n_src_views = int(cfg.n_src_views)
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

    # ------------------------------ eval entry ------------------------------

    @property
    def output_path(self) -> str:
        """<output_root>/<name>: where the eval entry writes."""
        return os.path.join(str(self.cfg.output_root), str(self.cfg.name))

    def load_dataset(self, splits: List[str]):
        """Test loaders of every dataset under data_test (engine.py:81); the
        port has the COLMAP loader only."""
        for split in splits:
            if split != "test":
                raise NotImplementedError(f"the port loads the test split only, not {split}")
            self.test_loaders = []
            for data_cfg in (self.cfg.get("data_test") or {}).values():
                if data_cfg is None:
                    continue
                if data_cfg.dataset_name not in DATASETS:
                    raise NotImplementedError(
                        f"dataset {data_cfg.dataset_name} is not ported (COLMAP only)")
                dataset = DATASETS[data_cfg.dataset_name](
                    data_cfg.root_dir, split, n_views=self.n_src_views,
                    img_wh=tuple(data_cfg.img_wh), max_len=data_cfg.get("max_len", -1),
                    scene_list=data_cfg.get("scene_list"),
                    test_views_method=data_cfg.get("test_views_method", "nearest"),
                    nf_mode=data_cfg.get("nf_mode", "avg"))
                self.test_loaders.append(DataLoader(dataset, int(self.cfg.batch_size)))
                log.info("loaded test set of %s (%d samples)", data_cfg.dataset_name,
                         len(dataset))

    def build_networks(self):
        """The model with weights from the config's seed (engine.py:123)."""
        gen = torch.Generator().manual_seed(int(self.cfg.get("seed") or 0))
        self.model = init_matchnerf(self.cfg, gen).to(self.device).eval()
        self.renderer.model = self.model

    def restore_checkpoint_if_needed(self):
        """Weights from `load`, a reference `.pth` (engine.py:194): its
        "model" entry (or the whole file), "module." prefixes stripped, into
        the model with strict key matching, the port's key names being the
        reference's."""
        path = self.cfg.get("load")
        if self.cfg.get("resume"):
            raise NotImplementedError("resume: the port has no training checkpoints yet")
        if not path:
            log.info("no checkpoint to load: the weights stay those of the seed")
            return
        if not os.path.isfile(path):
            raise FileNotFoundError(f"checkpoint {path} not found (pass --load= to keep "
                                    "the seeded weights)")
        log.info("loading weights from checkpoint %s", path)
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
        # DataParallel prefixes, on the model and on its two children
        # (import_torch.py:193-197)
        strip = re.compile(r"^(feat_enc\.|nerf_dec\.)?module\.")
        sd = {strip.sub(r"\1", re.sub(r"^module\.", "", k)): v for k, v in sd.items()}
        self.model.load_state_dict(sd, strict=True)

    def _out_name(self, batch, b: int, ep=None, it=True) -> str:
        src_ids = "_".join(f"{x:02d}" for x in batch["view_ids"][b][: self.n_src_views])
        name = f"{batch['scene'][b]}_view{batch['view_ids'][b][-1]:02d}_src{src_ids}"
        if it and self.it:
            name = f"it{self.it}_{name}"
        return name if ep is None else f"ep{ep}_{name}"

    def test_model(self, ep=None, save_images=True, separate_save=False) -> Dict:
        """Render every test view, save pred | gt (engine.py:544), score it
        (80 % centre crop: the COLMAP scenes have no depth mask) and write
        `0results_{dataset}.txt`; returns the per-dataset metric lists."""
        cfg = self.cfg
        test_outroot = os.path.join(self.output_path, "test")
        os.makedirs(test_outroot, exist_ok=True)
        eval_tools = EvalTools()
        metrics_dict: Dict[str, OrderedDict] = {}
        for data_loader in self.test_loaders:
            dataname = data_loader.dataset.get_name()
            metrics_dict[dataname] = OrderedDict()
            data_outdir = os.path.join(test_outroot, dataname)
            os.makedirs(data_outdir, exist_ok=True)
            for batch in data_loader:
                ret = self.renderer.forward(batch, mode="test")
                W, H = (int(x) for x in batch["img_wh"][0])
                B = batch["images"].shape[0]
                pred_rgb = ret["rgb"].cpu().numpy().reshape(B, H, W, 3)
                pred_depth = ret["depth"].cpu().numpy().reshape(B, H, W)
                for b in range(B):
                    gt_rgb = np.asarray(batch["images"][b, -1])
                    pred_u8 = (pred_rgb[b] * 255).astype(np.uint8)
                    gt_u8 = (gt_rgb * 255).astype(np.uint8)
                    out_name = self._out_name(batch, b, ep)
                    if separate_save:
                        save_image(os.path.join(data_outdir, f"{out_name}_pred.png"), pred_u8)
                        save_image(os.path.join(data_outdir, f"{out_name}_gt.png"), gt_u8)
                        for s in range(self.n_src_views):
                            src_u8 = (np.asarray(batch["images"][b, s]) * 255).astype(np.uint8)
                            save_image(os.path.join(data_outdir, f"{out_name}_{s}_src.png"),
                                       src_u8)
                    elif save_images:
                        if cfg.get("vis_depth"):
                            minmax = np.asarray(batch["near_fars"][b, -1]).tolist()
                            img_vis = np.concatenate(
                                [visualize_depth(pred_depth[b], minmax), pred_u8, gt_u8], axis=1)
                        else:
                            img_vis = np.concatenate([pred_u8, gt_u8], axis=1)
                        save_image(os.path.join(data_outdir, f"{out_name}.png"), img_vis)
                    eval_tools.set_inputs(pred_rgb[b], gt_rgb)
                    view = f"{batch['scene'][b]}_{batch['view_ids'][b][-1]:03d}"
                    metrics_dict[dataname][view] = eval_tools.get_metrics()
        sum_dict = summarize_metrics(metrics_dict, test_outroot, ep=ep)
        for dataname, data_metric in sum_dict.items():
            avg = {k: float(np.nanmean(vv)) for k, v in data_metric.items()
                   if not np.all(np.isnan(vv := np.asarray(v, np.float64)))}
            log.info("%s: PSNR %.2f, SSIM %.3f, LPIPS %.3f", dataname.upper(),
                     avg.get("PSNR", float("nan")), avg.get("SSIM", float("nan")),
                     avg.get("LPIPS", float("nan")))
        return sum_dict

    def test_model_video(self, ep=None) -> List[np.ndarray]:
        """Render each batch's trajectory and write it (engine.py:628): the
        video (`write_video`), the GIF with nerf.save_gif, the frames with
        nerf.save_frames, and the source views side by side. Returns the
        rendered rgb of every batch element, [n_frames,H,W,3] f32 each."""
        cfg = self.cfg
        out_root = os.path.join(self.output_path, "test_videos")
        os.makedirs(out_root, exist_ok=True)
        videos = []
        for data_loader in self.test_loaders:
            dataname = data_loader.dataset.get_name()
            data_outdir = os.path.join(out_root, dataname)
            os.makedirs(data_outdir, exist_ok=True)
            mode = cfg.data_test[dataname].get("render_path_mode", "interpolate")
            for batch in data_loader:
                ret = self.renderer.forward(batch, mode="test", render_video=True,
                                            render_path_mode=mode)
                W, H = (int(x) for x in batch["img_wh"][0])
                B = batch["images"].shape[0]
                n_frames = int(cfg.nerf.video_n_frames)
                # forward() concatenates frames along dim 0: [n_frames*B, H*W, 3]
                pred_rgb = (ret["rgb"].cpu().numpy().reshape(n_frames, B, H, W, 3)
                            .transpose(1, 0, 2, 3, 4))
                for b in range(B):
                    videos.append(pred_rgb[b])
                    frames_u8 = [(pred_rgb[b, f] * 255).astype(np.uint8)
                                 for f in range(n_frames)]
                    out_name = self._out_name(batch, b, ep, it=False)
                    if cfg.nerf.get("save_frames"):
                        for f_idx, frame in enumerate(frames_u8):
                            save_image(os.path.join(data_outdir, f"{out_name}_f{f_idx}.png"),
                                       frame)
                    write_video(os.path.join(data_outdir, f"{out_name}.mp4"), frames_u8,
                                pts_rate=float(cfg.nerf.get("video_pts_rates", 2.0)))
                    if cfg.nerf.get("save_gif"):
                        write_gif(os.path.join(data_outdir, f"{out_name}.gif"), frames_u8)
                    srcs = np.concatenate(
                        [(np.asarray(batch["images"][b, i]) * 255).astype(np.uint8)
                         for i in range(self.n_src_views)], axis=1)
                    save_image(os.path.join(data_outdir, f"{out_name}.png"), srcs)
        return videos
