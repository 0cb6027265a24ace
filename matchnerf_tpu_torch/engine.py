"""The orchestrator (counterpart of `Coach` in matchnerf_tpu/engine.py):
the training loop, the eval and video entry.

Data (engine.py:81): `load_dataset` builds the train, val and test loaders
of the config's data_* blocks (DTU, IBRNet, LLFF, Blender, T&T and
COLMAP), the training loader shuffled per epoch.

Training (engine.py:180-545), the call order of train.py:
`build_networks` (the seeded model, and the GMFlow-pretrained encoder of
`encoder.pretrain_weight` where that file exists), `setup_optimizer`
(total steps from the loader's length),
`restore_checkpoint_if_needed` (`resume`: the model, optimizer and schedule
state, epoch and iteration of `models/latest.ckpt`; `load`: weights only),
`setup_visualizer` (tensorboard where importable, and always
`scalars.jsonl`), then `train_model`: epochs of `train_epoch` (inside a
`torch.profiler` trace written to `profile_trace_dir` when that key is set,
`utils.profiling.trace`), which on
resume skips the batches before the restored iteration, and
`train_iteration`: one step (the per-pose route of the cond query; a step
never takes Kernel C), then the hooks every `ceil(freq.x_it * len(loader))`
iterations: scalars, the asynchronous mid-epoch checkpoint, `validate_model`
and `test_model`; per epoch the log line, validation, test and the
checkpoint with its weights-only backup. SIGTERM or SIGINT saves
`latest.ckpt` at the last finished step and exits. The step's random draws
restart from the seed in every `train_model`, as the JAX step key does.

Eval (engine.py:544-684): `test_model` (images and PSNR / SSIM / LPIPS per
view, with `data_test.<set>.report_full_scores` also over the whole image,
summed up per scene and dataset; DTU masks pixels without depth; Blender
renders onto a white background) and `test_model_video` (a trajectory per
batch, written as video: DTU and Blender interpolate between the source
cameras, Blender onto white, LLFF takes the spiral, COLMAP its
`render_path_mode`), with the JAX package's output names.

Several ranks (`parallel/`; engine.py:51-178, :216-269): `parallel_plan`
picks the mode from the config and the ranks (one card each) by the JAX
rules: "batch" where the global batch divides over them (the training
loader then gives each rank its chunk), "rays" where the batch is 1 and
the rays divide (every rank loads the whole batch), else none.
`setup_parallel` (in `setup_optimizer`) builds the step for that mode and
splits the renders' rays; `setup_eval_parallel` (the eval entry) splits
the renders' rays over every rank. After `restore_checkpoint_if_needed`
every rank adopts rank 0's weights, optimizer state, epoch and iteration
(`_sync_state_from_host0`), whether or not it could read the checkpoint.
Rank 0 alone writes checkpoints, scalars, tensorboard, validation and
test images, videos and metric files; every rank runs every render, since
the renders gather across ranks.
"""
from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import signal
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from .data import DATASETS
from .data.loader import DataLoader
from .metrics import EvalTools, summarize_metrics
from .models.gmflow.gmflow import encoder_input_hw
from .models.matchnerf import MatchNeRF, init_matchnerf, local_radius
from .ops.block_cosine_prior import takes_f32
from .parallel import distributed as dist
from .renderer import Renderer, extract_poses
from .train_step import build_optimizer, make_train_step
from .utils.checkpoint import CheckpointWriter, load_checkpoint, load_model_weights
from .utils.containers import effective_precision
from .utils.logging import loss_train, update_timer
from .utils.profiling import trace
from .utils.visualize import save_image, visualize_depth, write_gif, write_video
from .weights import load_gmflow_pretrained

log = logging.getLogger(__name__)


def parallel_plan(cfg, n_ranks: int):
    """(mode, n) from the config and n_ranks ranks of one card each
    (engine.py:51 `_parallel_plan`, where devices are ranks x 1 card): mode
    "batch" (the global batch splits over the ranks), "rays" (batch_size 1
    recipes: the rays split), or None."""
    n = int((cfg.get("parallel") or {}).get("data_parallel", -1) or -1)
    n = n_ranks if n <= 0 else min(n, n_ranks)
    if n_ranks > 1 and n != n_ranks:
        log.warning("parallel.data_parallel=%d ignored under %d processes; using all %d "
                    "devices", n, n_ranks, n_ranks)
        n = n_ranks
    bsz = int(cfg.batch_size)
    n_rays = int((cfg.get("nerf") or {}).get("rand_rays_train") or 0) // max(bsz, 1)
    if n > 1 and bsz % n == 0 and bsz % n_ranks == 0:
        return "batch", n
    if n > 1 and n_rays and n_rays % n == 0:
        return "rays", n
    return None, n


class Coach:
    """Evaluates or trains one model on one device (the card unless the
    caller asks for the CPU). kernel=False runs every kernel's plain
    version. `model` may be None until `build_networks`.

    `setup_optimizer(total_steps)` builds the two-group AdamW (or Adam) and
    the step for the recipe's shape (data_train.img_wh, nerf.rand_rays_train);
    `train_iteration(batch)` takes one step on a numpy batch (images
    [1,V+1,H,W,3], extrinsics, intrinsics, near_fars as `Renderer.forward`
    takes them; `ray_idx` and `depth_rand` replace the step's draws, as
    `TrainStep` takes them) and returns {'render', 'all'}: device scalars, or floats
    (checked finite) on every `freq.scalar`-th iteration or with
    sync_loss_every_step. Its hooks run once `train_model` has set their
    periods; called alone it only steps."""

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
        self.ep = 0
        self.epoch_start = 0
        self.iter_start = 0
        self.opt = None
        self.step = None
        self.parallel_mode: Optional[str] = None
        self.last_route: Optional[tuple] = None
        self._route_cache: Dict[bytes, Optional[tuple]] = {}
        self.train_loader: Optional[DataLoader] = None
        self.val_loader: Optional[DataLoader] = None
        self.test_loaders: List[DataLoader] = []
        self.checkpoints = CheckpointWriter()
        self.timer: Optional[Dict] = None
        self.val_it = self.test_it = self.ckpt_it = None     # set by train_model
        self._tb = None
        self._in_step = False
        self._stop_signal: Optional[int] = None

    # ------------------------------ training --------------------------------

    def setup_parallel(self):
        """The parallel mode of the ranks (`parallel_plan`); under a mode the
        renders split their rays over the ranks too (engine.py:141)."""
        self.parallel_mode, n = parallel_plan(self.cfg, dist.process_count())
        self.renderer.set_ray_sharding(self.parallel_mode is not None)
        if self.parallel_mode is not None:
            log.info("%s-parallel over %d ranks (backend %s)", self.parallel_mode, n,
                     dist.backend())

    def setup_eval_parallel(self):
        """The eval entry's ray sharding over every rank (engine.py:160);
        nothing with one rank or once training set a mode."""
        n = dist.process_count()
        if self.renderer.ray_shards > 1 or n <= 1:
            return
        self.renderer.set_ray_sharding(True)
        log.info("eval ray sharding over %d ranks (backend %s)", n, dist.backend())

    def setup_optimizer(self, total_steps: Optional[int] = None):
        """The optimizer and the step, for the ranks' parallel mode
        (`setup_parallel`); total_steps defaults to the training loader's
        length times max_epoch (engine.py:180)."""
        cfg = self.cfg
        self.setup_parallel()
        if total_steps is None:
            if self.train_loader is None:
                raise RuntimeError("load the training data first (or give total_steps)")
            total_steps = len(self.train_loader) * int(cfg.max_epoch)
        W, H = cfg.data_train.img_wh
        n_rays = int(cfg.nerf.rand_rays_train) // max(int(cfg.batch_size), 1)
        self.train_hw = (int(H), int(W), n_rays)
        self.opt = build_optimizer(cfg, self.model, total_steps)
        self.step = make_train_step(cfg, self.model, self.opt, int(H), int(W), n_rays,
                                    kernel=self.kernel, generator=self.generator,
                                    mode=self.parallel_mode)
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
        reads its taps directly and needs no per-ray bucket). The unions are
        measured on the grids of the tables the step builds, 1/8 of the
        encoder's input (`encoder_input_hw`): at 756x1008 that is 96x128
        and 192x256, where the JAX package measures on (H // 8, W // 8),
        94x126 and 188x252, and can pick a bucket the tables' union
        overflows."""
        cfg = self.cfg
        prec = effective_precision(cfg)
        get = prec.get if hasattr(prec, "get") else (lambda *_: None)
        patches = bool(cfg.nerf.get("train_ray_patches", False))
        if not (get("banded_kernel") and get("block_kernel") and patches
                and int(cfg.batch_size) == 1) or local_radius(cfg) > 0:
            return None
        key = b"".join(np.asarray(batch[k], np.float32).tobytes()
                       for k in ("extrinsics", "intrinsics", "near_fars"))
        if key not in self._route_cache:
            H, W, _ = self.train_hw
            up = int(cfg.encoder.upsample_factor)
            enc_h, enc_w = encoder_input_hw(H, W)
            scale_hws = [(enc_h // 8, enc_w // 8), (enc_h // 8 * up, enc_w // 8 * up)]
            block_ut, _ = self.renderer.pose_prep(extract_poses(batch), scale_hws, H, W)
            route = None
            if block_ut is not None:
                S = int(cfg.nerf.sample_intvs)
                groups = cfg.encoder.cos_n_group
                groups = [groups] * len(scale_hws) if isinstance(groups, int) else list(groups)
                route = tuple(ut if ut is not None and takes_f32(ut, S, g, h * w,
                                                                 self.n_src_views) else None
                              for ut, g, (h, w) in zip(block_ut, groups, scale_hws))
                if all(u is None for u in route):
                    route = None
            log.info("training route: pose_prep block_ut %s -> per-scale %s "
                     "(None: Kernel B')", block_ut, route)
            self._route_cache[key] = route
        return self._route_cache[key]

    def train_iteration(self, batch: Dict, ray_idx: Optional[torch.Tensor] = None,
                        depth_rand: Optional[torch.Tensor] = None) -> Dict:
        if self.step is None:
            raise RuntimeError("call setup_optimizer first")
        if self.timer is not None:
            self.timer["it_start"] = time.time()
        route = self.train_route(batch)
        self.last_route = route
        self._in_step = True          # a stop signal waits for the step to finish
        try:
            loss = self.step(self.batch_tensors(batch), route, ray_idx, depth_rand)
            self.it += 1
        finally:
            self._in_step = False
        if self._stop_signal is not None:
            self._save_and_exit()
        cfg = self.cfg
        freq = cfg.get("freq") or {}
        if self.timer is not None:
            self.timer["it_end"] = time.time()
            update_timer(self.timer, int(cfg.max_epoch), self.ep, len(self.train_loader))
        scalar = int(freq.get("scalar", 0) or 0)
        if bool(cfg.get("sync_loss_every_step", False)) or (
                scalar > 0 and self.it % scalar == 0):
            loss = {k: float(v) for k, v in loss.items()}
            for k, v in loss.items():
                if not math.isfinite(v):
                    raise FloatingPointError(f"loss {k} is {v} at iteration {self.it}")
        if scalar > 0 and self.it % scalar == 0:
            self.log_scalars(loss=loss, lrates=self.get_cur_lrates(), step=self.it,
                             split="train")
        if self.ckpt_it and self.ckpt_it > 0 and self.it % self.ckpt_it == 0:
            self.save_checkpoint_now(ep=self.ep, it=self.it, backup_ckpt=False,
                                     async_write=True)
        if self.val_it and self.val_it > 0 and self.it % self.val_it == 0:
            self.validate_model(iteration=self.it)
        if self.test_it and self.test_it > 0 and self.it % self.test_it == 0:
            self.test_model(ep=self.ep, save_images=bool(cfg.get("save_test_image", False)))
        return loss

    def train_model(self):
        """Train from `epoch_start` / `iter_start` to max_epoch (engine.py:333)."""
        cfg = self.cfg
        log.info("TRAINING START")
        previous = self._install_preemption_handler()
        try:
            self.timer = {"start": time.time(), "it_mean": None}
            self.it = self.iter_start
            self.ep = self.epoch_start
            n_loader = len(self.train_loader)
            freq = cfg.freq

            def period(x):
                return math.ceil(x * n_loader) if x > 0 else x

            self.val_it, self.test_it, self.ckpt_it = (
                period(freq.val_it), period(freq.test_it), period(freq.ckpt_it))
            # the step's draws restart from the seed, as the JAX step key does
            # on every train_model, resumed or not (engine.py:353)
            self.generator.manual_seed(int(cfg.get("seed") or 0))
            if cfg.get("sanity_check") and self.it == 0:
                if self.val_it and self.val_it > 0 and self.val_loader is not None:
                    self.validate_model(iteration=self.it, is_sanity_check=True)
                if freq.test_ep > 0 and self.test_loaders:
                    self.test_model(ep=0, save_images=False, is_sanity_check=True)
            trace_dir = cfg.get("profile_trace_dir")
            with trace(trace_dir) if trace_dir else contextlib.nullcontext():
                for self.ep in range(self.epoch_start, int(cfg.max_epoch)):
                    self.train_epoch()
            if self._tb is not None:
                self._tb.flush()
            log.info("TRAINING DONE")
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
            self.checkpoints.wait()

    def train_epoch(self):
        """One pass over the training loader (engine.py:375); on resume the
        batches before `iter_start` are loaded and skipped."""
        cfg = self.cfg
        freq = cfg.freq
        self.train_loader.set_epoch(self.ep)
        n_loader = len(self.train_loader)
        last_loss = None
        for batch_idx, batch in enumerate(self.train_loader):
            if cfg.get("resume") and self.ep * n_loader + batch_idx < self.iter_start:
                continue
            last_loss = self.train_iteration(batch)
        if freq.log_ep > 0 and (self.ep + 1) % freq.log_ep == 0 and last_loss:
            loss_train(log, cfg.max_epoch, self.ep + 1, self.get_cur_lrates(),
                       float(last_loss["all"]), self.timer)
        if freq.val_ep > 0 and (self.ep + 1) % freq.val_ep == 0:
            self.validate_model(iteration=self.it)
        if (self.ep >= freq.test_ep_start and freq.test_ep > 0
                and (self.ep + 1) % freq.test_ep == 0):
            self.test_model(ep=self.ep + 1, save_images=bool(cfg.get("save_test_image", False)))
        if freq.ckpt_ep > 0 and (self.ep + 1) % freq.ckpt_ep == 0:
            self.save_checkpoint_now(ep=self.ep + 1, it=self.it, backup_ckpt=True)

    def _install_preemption_handler(self) -> Dict:
        """SIGTERM and SIGINT save `latest.ckpt` and exit with 128 + signal
        (engine.py:316): at once between steps, or when the running step has
        finished, so the file never holds a half-updated model. Returns the
        handlers it replaced."""
        def handler(signum, frame):
            self._stop_signal = signum
            if not self._in_step:
                self._save_and_exit()

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:            # not the main thread
                pass
        return previous

    def _save_and_exit(self):
        signum, self._stop_signal = self._stop_signal, None
        log.warning("received signal %d; saving a checkpoint at iteration %d before exit",
                    signum, self.it)
        self.save_checkpoint_now(ep=self.ep, it=self.it, backup_ckpt=False)
        raise SystemExit(128 + signum)

    # -------------------------- checkpoints, logging --------------------------

    def save_checkpoint_now(self, ep: int, it: int, backup_ckpt: bool = True,
                            async_write: bool = False):
        """`models/latest.ckpt` (+ `ep{ep}_it{it}.ckpt`, weights only) under
        the output path (engine.py:235); async_write for the mid-epoch saves.
        Rank 0 alone writes (the ranks hold the same state)."""
        if not dist.is_main_process():
            return
        ckpt = {"model": self.model.state_dict()}
        if self.opt is not None:
            ckpt["optim"] = self.opt.state_dict()
        self.checkpoints.save(self.output_path, ckpt, ep=ep, it=it,
                              backup_ckpt=backup_ckpt, async_write=async_write)

    @property
    def scalars_path(self) -> str:
        return os.path.join(self.output_path, "scalars.jsonl")

    def setup_visualizer(self):
        """A tensorboard writer with cfg.tb where tensorboard is importable
        (engine.py:251); scalars.jsonl is written either way. Rank 0's
        alone."""
        if self.cfg.get("tb") and dist.is_main_process():
            try:
                from torch.utils import tensorboard
            except ImportError:
                log.warning("tensorboard unavailable; scalars.jsonl only")
                return
            self._tb = tensorboard.SummaryWriter(log_dir=self.output_path, flush_secs=10)

    def log_scalars(self, loss=None, metric=None, lrates=None, step=0, split="train"):
        """One JSON line per call in scalars.jsonl, and the same scalars to
        tensorboard (engine.py:260), by rank 0."""
        if not dist.is_main_process():
            return
        record = {"step": int(step), "split": split, "time": time.time()}
        for k, v in (loss or {}).items():
            if k != "all":
                record[f"loss_{k}"] = float(v)
        for k, v in (metric or {}).items():
            record[k] = float(np.mean(np.asarray(v, np.float64)))
        for k, v in (lrates or {}).items():
            record[f"lr_{k}"] = float(v)
        os.makedirs(self.output_path, exist_ok=True)
        with open(self.scalars_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in record.items():
                if k not in ("step", "split", "time"):
                    self._tb.add_scalar(f"{split}/{k}", v, step)

    def get_cur_lrates(self) -> Dict[str, float]:
        """Each group's scheduled rate at the current iteration (engine.py:282)."""
        out = {}
        for name in ("enc", "dec"):
            sched = self.opt.schedules.get(name) if self.opt is not None else None
            base = float(self.cfg.optim.get(f"lr_{name}", 0.0))
            out[name] = float(sched(self.it)) if (sched and base > 0) else base
        return out

    # ------------------------------ eval entry ------------------------------

    @property
    def output_path(self) -> str:
        """<output_root>/<name>: where the eval entry writes."""
        return os.path.join(str(self.cfg.output_root), str(self.cfg.name))

    def load_dataset(self, splits: List[str]):
        """The loaders of the data_train, data_val and every data_test block
        (engine.py:81); the training loader shuffles per epoch, and in
        "batch" mode gives each rank its chunk of every batch."""
        seed = int(self.cfg.get("seed") or 0)
        mode, _ = parallel_plan(self.cfg, dist.process_count())
        shards = ((dist.process_count(), dist.process_index()) if mode == "batch"
                  else (1, 0))
        for split in splits:
            if not self.cfg.get(f"data_{split}"):
                continue
            if split == "test":
                data_cfgs = list(self.cfg.data_test.values())
                self.test_loaders = []
            else:
                data_cfgs = [self.cfg.get(f"data_{split}")]
            for data_cfg in data_cfgs:
                if data_cfg is None:
                    continue
                name = data_cfg.dataset_name
                if name not in DATASETS:
                    raise NotImplementedError(
                        f"the {name} loader (matchnerf_tpu/data/) is not ported; the port "
                        f"has {sorted(DATASETS)}")
                dataset = DATASETS[name](
                    data_cfg.root_dir, split, n_views=self.n_src_views,
                    img_wh=tuple(data_cfg.img_wh), max_len=data_cfg.get("max_len", -1),
                    scene_list=data_cfg.get("scene_list"),
                    test_views_method=data_cfg.get("test_views_method", "nearest"),
                    nf_mode=data_cfg.get("nf_mode", "avg"),
                    eval_mode=data_cfg.get("eval_mode", "mvsnerf"),
                    n_add_train_views=data_cfg.get("n_add_train_views", 2),
                    meta_dir=data_cfg.get("meta_dir"))
                train = split == "train"
                loader = DataLoader(dataset, int(self.cfg.batch_size), shuffle=train,
                                    seed=seed, num_shards=shards[0] if train else 1,
                                    shard_id=shards[1] if train else 0)
                if split == "test":
                    self.test_loaders.append(loader)
                else:
                    setattr(self, f"{split}_loader", loader)
                log.info("loaded %s set of %s (%d samples)", split, name, len(dataset))

    def build_networks(self):
        """The model with weights from the config's seed (engine.py:123);
        then, when encoder.pretrain_weight names a file and neither load
        nor resume is set, the GMFlow checkpoint's backbone and transformer
        layers in the encoder (`weights.load_gmflow_pretrained`;
        `featup_net` and the decoder keep the seed's weights). A named file
        that is absent only warns, as in the JAX package."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(int(cfg.get("seed") or 0))
        self.model = init_matchnerf(cfg, gen)
        pretrain = (cfg.get("encoder") or {}).get("pretrain_weight")
        if pretrain and not cfg.get("load") and not cfg.get("resume"):
            if os.path.isfile(pretrain):
                load_gmflow_pretrained(self.model.feat_enc, pretrain)
                log.info("loaded the GMFlow pretrained weights %s into the encoder", pretrain)
            else:
                log.warning("pretrain weight %s not found; the encoder starts from the seed",
                            pretrain)
        self.model = self.model.to(self.device).eval()
        self.renderer.model = self.model

    def restore_checkpoint_if_needed(self):
        """With `resume`, the model, the optimizer and schedule state, epoch
        and iteration of `<output_path>/models/latest.ckpt` (engine.py:194;
        none there: from scratch). Else the weights of `load`: a checkpoint
        of the port's, or a reference `.pth`: its "model" entry (or the
        whole file), "module." prefixes stripped, into the model with strict
        key matching, the port's key names being the reference's. Then every
        rank adopts rank 0's state (`_sync_state_from_host0`)."""
        self._restore()
        self._sync_state_from_host0()

    def _restore(self):
        path = self.cfg.get("load")
        if self.cfg.get("resume"):
            ckpt_path = os.path.join(self.output_path, "models", "latest.ckpt")
            if not os.path.isfile(ckpt_path):
                log.warning("no checkpoint at %s: training starts from scratch", ckpt_path)
                return
            log.info("resuming from %s", ckpt_path)
            ckpt = load_checkpoint(ckpt_path)
            self.model.load_state_dict(ckpt["model"], strict=True)
            if self.opt is not None and "optim" in ckpt:
                self.opt.load_state_dict(ckpt["optim"])
            self.epoch_start, self.iter_start = int(ckpt["epoch"]), int(ckpt["iter"])
            return
        if not path:
            log.info("no checkpoint to load: the weights stay those of the seed")
            return
        log.info("loading weights from checkpoint %s", path)
        load_model_weights(self.model, path)

    def _sync_state_from_host0(self):
        """Every rank adopts rank 0's weights, optimizer and schedule state,
        epoch and iteration (engine.py:216): on clusters without a shared
        file system only rank 0 may see the checkpoint."""
        if dist.process_count() == 1:
            return
        state = dist.broadcast_tree({
            "model": self.model.state_dict(),
            "optim": None if self.opt is None else self.opt.state_dict(),
            "ep": int(self.epoch_start), "it": int(self.iter_start)})
        self.model.load_state_dict(state["model"], strict=True)
        if self.opt is not None:
            self.opt.load_state_dict(state["optim"])
        self.epoch_start, self.iter_start = state["ep"], state["it"]

    def _out_name(self, batch, b: int, ep=None, it=True) -> str:
        src_ids = "_".join(f"{x:02d}" for x in batch["view_ids"][b][: self.n_src_views])
        name = f"{batch['scene'][b]}_view{batch['view_ids'][b][-1]:02d}_src{src_ids}"
        if it and self.timer is not None:      # inside training (train_model)
            name = f"it{self.it}_{name}"
        return name if ep is None else f"ep{ep}_{name}"

    def validate_model(self, iteration=None, is_sanity_check=False) -> Dict:
        """Render every validation view (mode "val"), save depth | pred | gt
        as `validation/{scene}_view{id}_it{iteration}.jpg` (PNG bytes), score
        it (DTU: pixels without depth masked) and log the mean metrics
        (engine.py:504); returns the per-view metric lists. Every rank
        renders and scores; rank 0 writes."""
        if self.val_loader is None:
            raise RuntimeError("load the validation data first")
        main = dist.is_main_process()
        out_dir = os.path.join(self.output_path, "validation")
        if main:
            os.makedirs(out_dir, exist_ok=True)
        eval_tools = EvalTools(self.device)
        metrics: Dict[str, list] = {k: [] for k in eval_tools.support_metrics}
        dtu = self.val_loader.dataset.get_name().startswith("dtu")
        for batch_idx, batch in enumerate(self.val_loader):
            if is_sanity_check and batch_idx > 0:
                break
            ret = self.renderer.forward(batch, mode="val")
            W, H = (int(x) for x in batch["img_wh"][0])
            B = batch["images"].shape[0]
            pred_rgb = ret["rgb"].cpu().numpy().reshape(B, H, W, 3)
            pred_depth = ret["depth"].cpu().numpy().reshape(B, H, W)
            for b in range(B):
                gt_rgb = np.asarray(batch["images"][b, -1])
                minmax = np.asarray(batch["near_fars"][b, -1]).tolist()
                img_vis = np.concatenate(
                    [visualize_depth(pred_depth[b], minmax),
                     (pred_rgb[b] * 255).astype(np.uint8), (gt_rgb * 255).astype(np.uint8)],
                    axis=1)
                if main:
                    save_image(os.path.join(out_dir, f"{batch['scene'][b]}_view"
                                            f"{batch['view_ids'][b][-1]}_it{iteration}.jpg"),
                               img_vis)
                mask = None
                if dtu:
                    if "depth" not in batch:
                        raise KeyError("DTU validation needs the samples' 'depth'")
                    mask = np.asarray(batch["depth"][b]) == 0
                eval_tools.set_inputs(pred_rgb[b], gt_rgb, mask)
                for k, v in eval_tools.get_metrics().items():
                    metrics[k].append(v)
        self.log_scalars(metric=metrics, step=iteration or 0, split="val")
        return metrics

    def test_model(self, ep=None, save_images=True, separate_save=False,
                   is_sanity_check=False) -> Dict:
        """Render every test view, save pred | gt (engine.py:544), score it
        (pixels without depth masked where the samples carry depth, else
        an 80 % centre crop; with the set's `report_full_scores` the whole
        image too), write `0results_{dataset}.txt` and log each dataset's
        mean metrics; returns the per-dataset metric lists. Blender's views
        render onto a white background (the renderer's `setbg_opaque`, set
        for that set only). Every rank renders and scores; rank 0 writes."""
        cfg = self.cfg
        main = dist.is_main_process()
        test_outroot = os.path.join(self.output_path, "test")
        eval_tools = EvalTools(self.device)
        metrics_dict: Dict[str, OrderedDict] = {}
        for data_loader in self.test_loaders:
            dataname = data_loader.dataset.get_name()
            metrics_dict[dataname] = OrderedDict()
            data_outdir = os.path.join(test_outroot, dataname)
            if main:
                os.makedirs(data_outdir, exist_ok=True)
            report_full = bool(((cfg.get("data_test") or {}).get(dataname) or {}).get(
                "report_full_scores", False))
            self.renderer.setbg_opaque = dataname == "blender"
            for batch_idx, batch in enumerate(data_loader):
                if is_sanity_check and batch_idx > 0:
                    break
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
                    if separate_save and main:
                        save_image(os.path.join(data_outdir, f"{out_name}_pred.png"), pred_u8)
                        save_image(os.path.join(data_outdir, f"{out_name}_gt.png"), gt_u8)
                        for s in range(self.n_src_views):
                            src_u8 = (np.asarray(batch["images"][b, s]) * 255).astype(np.uint8)
                            save_image(os.path.join(data_outdir, f"{out_name}_{s}_src.png"),
                                       src_u8)
                    elif save_images and main:
                        if cfg.get("vis_depth"):
                            minmax = np.asarray(batch["near_fars"][b, -1]).tolist()
                            img_vis = np.concatenate(
                                [visualize_depth(pred_depth[b], minmax), pred_u8, gt_u8], axis=1)
                        else:
                            img_vis = np.concatenate([pred_u8, gt_u8], axis=1)
                        save_image(os.path.join(data_outdir, f"{out_name}.png"), img_vis)
                    mask = np.asarray(batch["depth"][b]) == 0 if "depth" in batch else None
                    eval_tools.set_inputs(pred_rgb[b], gt_rgb, mask)
                    view = f"{batch['scene'][b]}_{batch['view_ids'][b][-1]:03d}"
                    metrics_dict[dataname][view] = eval_tools.get_metrics(
                        return_full=report_full)
            self.renderer.setbg_opaque = False
        sum_dict = summarize_metrics(metrics_dict, test_outroot if main else None, ep=ep)
        for dataname, data_metric in sum_dict.items():
            avg = {k: float(np.nanmean(vv)) for k, v in data_metric.items()
                   if not np.all(np.isnan(vv := np.asarray(v, np.float64)))}
            log.info("%s: PSNR %.2f, SSIM %.3f, LPIPS %.3f", dataname.upper(),
                     avg.get("PSNR", float("nan")), avg.get("SSIM", float("nan")),
                     avg.get("LPIPS", float("nan")))
            self.log_scalars(metric=avg, step=ep or 0, split=dataname)
        return sum_dict

    def test_model_video(self, ep=None) -> List[np.ndarray]:
        """Render each batch's trajectory and write it (engine.py:628): the
        video (`write_video`), the GIF with nerf.save_gif, the frames with
        nerf.save_frames, and the source views side by side. The path and
        background go by dataset (engine.py:636): DTU and Blender
        interpolate between the source cameras, Blender onto white; LLFF
        takes the spiral around the train views; COLMAP the set's
        `render_path_mode`; any other set (T&T) raises. Returns the rendered
        rgb of every batch element, [n_frames,H,W,3] f32 each. Every rank
        renders (and returns); rank 0 writes."""
        cfg = self.cfg
        main = dist.is_main_process()
        out_root = os.path.join(self.output_path, "test_videos")
        videos = []
        for data_loader in self.test_loaders:
            dataname = data_loader.dataset.get_name()
            data_outdir = os.path.join(out_root, dataname)
            if main:
                os.makedirs(data_outdir, exist_ok=True)
            self.renderer.setbg_opaque = dataname == "blender"
            if "dtu" in dataname or dataname == "blender":
                mode = "interpolate"
            elif dataname == "llff":
                mode = "spiral"
            elif dataname == "colmap":
                mode = cfg.data_test.colmap.get("render_path_mode", "interpolate")
            else:
                raise ValueError(f"Unknown dataset for rendering video {dataname}")
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
                    if not main:
                        continue
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
        self.renderer.setbg_opaque = False
        return videos
