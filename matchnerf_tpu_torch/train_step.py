"""The training step: loss, optimizer, schedules (counterpart of
matchnerf_tpu/train_step.py).

One step is encode -> f32 sampling tables -> `render_rays` on `n_rays`
random target pixels with stratified depths -> render_w * MSE -> backward
-> AdamW (or Adam) in two parameter groups (`feat_enc`, `nerf_dec`) with
OneCycle (or ExponentialLR) schedules and global-norm clipping of the
encoder group.

- `make_schedule` is optax.cosine_onecycle_schedule as the JAX package
  builds it (not torch's OneCycleLR, whose phase boundaries differ), or
  optax.exponential_decay(peak, transition_steps=1, decay_rate=gamma) for
  ExponentialLR (a decay per step, not per epoch as torch's), evaluated in
  float32 in optax's operation order.
- `build_optimizer` returns a `TrainOptimizer`: torch AdamW (b1 0.9, b2
  0.999, eps 1e-8, decoupled weight decay on every parameter), or for
  `algo.type: Adam` torch Adam with the same moments and eps and no weight
  decay whatever `weight_decay` says (optax.adam), per active group; a
  group with lr <= 0 is frozen (optax.set_to_zero: no update, no decay);
  the encoder group is clipped first with optax's clip_by_global_norm
  (scale by max_norm / norm only when norm >= max_norm). Update k (from 0)
  uses the schedules' value at step k.
- `make_train_step` builds the step for one (H, W, n_rays) shape. The rays
  are a permutation of the H*W pixels (or, under nerf.train_ray_patches, of
  the (H*W)/8 8-pixel strips) drawn from a torch.Generator on the device,
  which also draws the stratified depth jitter. Two runs of the same seed
  give the same losses and parameters bit for bit, on the CPU and on the
  card (cuDNN in its deterministic mode; every backward the port writes
  sums in a fixed order).

Several ranks (`parallel/`; train_step.py:89-135): mode "rays" (batch_size
1, every shipped recipe) gives each rank the whole batch and its contiguous
n_rays / n share of the rays: every rank draws the global ray indices and
depth jitter from its identically seeded generator, so the generators stay
in step, and keeps its share (under train_ray_patches, whole 8-pixel
strips); with parallel.shard_encoder_streams each rank also runs its share
of the encoder's streams. Mode "batch" gives each rank its chunk of the
global batch (the loader's shard); the per-sample jitter of the global
batch is drawn whole and sliced. Whenever a process group is up, the
gradients are averaged over the ranks after the backward, before the
encoder clip and the update (the JAX psum before clip_by_global_norm), and
the step returns the global loss.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .models.matchnerf import MatchNeRF, encode, prepare_sampling_tables, render_rays
from .parallel import distributed as dist
from .parallel import mesh

STRIP = 8                      # pixels per strip under nerf.train_ray_patches


def make_schedule(optim_cfg, peak_lr: float, total_steps: int) -> Callable[[int], float]:
    """step -> learning rate (train_step.py:29). OneCycleLR is optax's
    cosine onecycle: pct_start = max(pct_start, 1/max(T, 2)), boundaries
    int(pct_start*T) and T, values peak/div, peak and peak/(div*final_div),
    cosine interpolation; ExponentialLR is optax's exponential decay,
    peak * gamma ** step; all in float32 as optax evaluates them."""
    sched = optim_cfg.get("sched") if hasattr(optim_cfg, "get") else None
    f32 = np.float32
    if not sched:
        return lambda step: float(f32(peak_lr))
    if sched["type"] == "ExponentialLR":
        gamma = f32(float(sched.get("gamma", 1.0)))

        def exponential(step: int) -> float:
            lr = f32(peak_lr) * gamma ** f32(step)
            # XLA flushes f32 subnormals to zero
            return float(lr) if abs(lr) >= np.finfo(f32).tiny else 0.0

        return exponential
    if sched["type"] != "OneCycleLR":
        raise ValueError(f"Unknown scheduler {sched['type']}")
    pct_start = max(float(sched.get("pct_start", 0.3)), 1.0 / max(total_steps, 2))
    div = float(sched.get("div_factor", 25.0))
    final_div = float(sched.get("final_div_factor", 1e4))
    bounds = (0, int(pct_start * total_steps), int(total_steps))
    values = np.cumprod([peak_lr / div, div, 1.0 / (div * final_div)])

    def schedule(step: int) -> float:
        if step >= bounds[2]:
            return float(f32(values[2]))
        i = 0 if step < bounds[1] else 1
        pct = f32(step - bounds[i]) / f32(bounds[i + 1] - bounds[i])
        cos = f32(math.cos(float(f32(f32(math.pi) * pct))))
        half = f32((values[i] - values[i + 1]) / 2.0)
        return float(f32(values[i + 1]) + half * (cos + f32(1.0)))

    return schedule


class TrainOptimizer:
    """Two-group AdamW or Adam with per-group schedules and encoder
    clipping (train_step.py:52 `build_optimizer`)."""

    def __init__(self, cfg, model: MatchNeRF, total_steps: int):
        optim_cfg = cfg.optim
        algo = optim_cfg.algo.type
        if algo not in ("AdamW", "Adam"):
            raise ValueError(f"optimizer {algo!r}: AdamW or Adam")
        wd = float(optim_cfg.algo.get("weight_decay", 0.0))
        clip = optim_cfg.get("clip_enc")
        self.clip_enc = None if clip is None else float(clip)
        self.schedules: Dict[str, Callable[[int], float]] = {}
        self.params = {"enc": list(model.feat_enc.parameters()),
                       "dec": list(model.nerf_dec.parameters())}
        groups = []
        for name, lr in (("enc", float(optim_cfg.lr_enc)), ("dec", float(optim_cfg.lr_dec))):
            if lr <= 0:
                continue                       # frozen: no update, no decay
            self.schedules[name] = make_schedule(optim_cfg, lr, total_steps)
            groups.append({"params": self.params[name], "lr": self.schedules[name](0),
                           "name": name})
        # optax.adam has no weight decay
        opt_cls, decay = (torch.optim.AdamW, wd) if algo == "AdamW" else (torch.optim.Adam, 0.0)
        self.opt = (opt_cls(groups, betas=(0.9, 0.999), eps=1e-8, weight_decay=decay)
                    if groups else None)
        self.count = 0

    def zero_grad(self):
        for ps in self.params.values():
            for p in ps:
                p.grad = None

    @torch.no_grad()
    def clip_encoder(self):
        """optax.clip_by_global_norm on the encoder's gradients."""
        grads = [p.grad for p in self.params["enc"] if p.grad is not None]
        if self.clip_enc is None or not grads:
            return
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        # t / norm * max_norm, as optax forms it, where the clip triggers
        for g in grads:
            g.copy_(torch.where(norm < self.clip_enc, g, g / norm * self.clip_enc))

    def state_dict(self) -> Dict:
        """The optimizer's state (under "adamw", Adam's too) and the
        schedules' step count (what a resumed run restores)."""
        return {"adamw": None if self.opt is None else self.opt.state_dict(),
                "count": self.count}

    def load_state_dict(self, state: Dict):
        if self.opt is not None:
            self.opt.load_state_dict(state["adamw"])
        self.count = int(state["count"])

    def step(self):
        if "enc" in self.schedules:
            self.clip_encoder()
        if self.opt is not None:
            for group in self.opt.param_groups:
                group["lr"] = self.schedules[group["name"]](self.count)
            self.opt.step()
        self.count += 1


def build_optimizer(cfg, model: MatchNeRF, total_steps: int) -> TrainOptimizer:
    return TrainOptimizer(cfg, model, total_steps)


def sample_ray_indices(n_pixels: int, n_rays: int, patches: bool, device,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[n_rays] int64 pixel indices without replacement (train_step.py:165):
    a permutation of the pixels, or of the 8-pixel strips, each strip
    expanded to its 8 consecutive pixels."""
    if patches:
        starts = torch.randperm(n_pixels // STRIP, generator=generator,
                                device=device)[:n_rays // STRIP] * STRIP
        return (starts[:, None] + torch.arange(STRIP, device=device)[None]).reshape(-1)
    return torch.randperm(n_pixels, generator=generator, device=device)[:n_rays]


class TrainStep:
    """One training step of a fixed (H, W, n_rays) shape
    (train_step.py:89 `make_train_step`).

    `step.loss(batch, ...)` is the forward alone (the loss to differentiate,
    and the MSE); `step(batch, ...)` runs forward, backward and the
    optimizer update and returns {'render': mse, 'all': loss} as detached
    device scalars. `batch` holds device tensors: images [B,V+1,H,W,3],
    extrinsics [B,V+1,3|4,4], intrinsics [B,V+1,3,3], near_fars [B,V+1,2]
    and tgt_c2w [B,3,4]. `block_ut` is the pose's per-scale route (see
    `engine.Coach`); `ray_idx` [n_rays] and `depth_rand` [B,n_rays,S,1]
    replace the generator's draws (tests feed the JAX draws through them).
    kernel=False runs every kernel's plain version (the all-plain
    reference on the card). `mode` is the parallel mode ("rays", "batch"
    or None; module docstring); the draws fed in are the global ones
    (ray_idx [n_rays], depth_rand [B * ranks in batch mode, n_rays, S, 1])
    and the step takes the rank's share of them."""

    def __init__(self, cfg, model: MatchNeRF, opt: TrainOptimizer, img_h: int, img_w: int,
                 n_rays: int, kernel: bool = True,
                 generator: Optional[torch.Generator] = None, mode: Optional[str] = None):
        self.cfg, self.model, self.opt = cfg, model, opt
        self.mode = mode
        # one seed, one trajectory, as the JAX step: cuDNN's convolution
        # backward on the card may otherwise pick algorithms that add with
        # atomics (the prior kernels' and the upsampler's backward sum in a
        # fixed order themselves)
        torch.backends.cudnn.deterministic = True
        self.img_h, self.img_w, self.n_rays = img_h, img_w, n_rays
        self.kernel = kernel
        self.generator = generator
        lw = cfg.loss_weight.get("render", 1.0)
        self.render_w = float(lw or 0.0)
        self.stratified = bool(cfg.nerf.sample_stratified)
        self.patches = bool(cfg.nerf.get("train_ray_patches", False))
        sampler = str(cfg.nerf.get("train_ray_sampler", "permutation"))
        if sampler != "permutation":
            raise NotImplementedError(f"train_ray_sampler {sampler!r} is not ported")
        if self.patches and n_rays % STRIP:
            raise ValueError(f"patch sampling needs n_rays divisible by {STRIP}")
        par = cfg.get("parallel") or {}
        self.shard_streams = mode == "rays" and bool(par.get("shard_encoder_streams", True))
        if mode == "rays":
            n = dist.process_count()
            if n_rays % n:
                raise ValueError(f"ray-sharded training needs n_rays ({n_rays}) divisible "
                                 f"by the ranks ({n})")
            if self.patches and (n_rays // n) % STRIP:
                raise ValueError(f"a rank's share of {n_rays // n} rays is not whole "
                                 f"{STRIP}-pixel strips")

    def loss(self, batch: Dict[str, torch.Tensor], block_ut: Optional[tuple] = None,
             ray_idx: Optional[torch.Tensor] = None,
             depth_rand: Optional[torch.Tensor] = None):
        cfg, H, W = self.cfg, self.img_h, self.img_w
        images = batch["images"]
        V = cfg.n_src_views
        B = images.shape[0]
        ref_images = images[:, :V]
        pair_feats = encode(self.model, cfg, ref_images, kernel=self.kernel,
                            shard_streams=self.shard_streams)
        tables = prepare_sampling_tables(cfg, pair_feats, ref_images)
        if ray_idx is None:
            ray_idx = sample_ray_indices(H * W, self.n_rays, self.patches, images.device,
                                         self.generator)
        if self.mode is not None:
            n_batch = B * dist.process_count() if self.mode == "batch" else B
            if depth_rand is None and self.stratified:
                depth_rand = torch.rand((n_batch, self.n_rays, cfg.nerf.sample_intvs, 1),
                                        generator=self.generator, dtype=torch.float32,
                                        device=images.device)
            if self.mode == "rays":
                share = mesh.chunk(self.n_rays)
                ray_idx = ray_idx[share]
                depth_rand = None if depth_rand is None else depth_rand[:, share]
            elif depth_rand is not None:
                depth_rand = depth_rand[mesh.chunk(n_batch)]
        off = 0.0 if cfg.nerf.legacy_coord else 0.5
        pix = torch.stack([(ray_idx % W).float() + off,
                           torch.div(ray_idx, W, rounding_mode="floor").float() + off], -1)
        pix = pix[None].expand(B, -1, 2)
        out = render_rays(
            self.model, cfg, pix, tgt_intr=batch["intrinsics"][:, -1],
            tgt_c2w=batch["tgt_c2w"], tgt_near_far=batch["near_fars"][:, -1],
            ref_w2c=batch["extrinsics"][:, :-1, :3, :],
            ref_intr=batch["intrinsics"][:, :-1],
            ref_near_far=batch["near_fars"][:, :-1], tables=tables, img_h=H, img_w=W,
            kernel=self.kernel, block_ut=block_ut, stratified=self.stratified,
            generator=self.generator, depth_rand=depth_rand)
        tgt = images[:, -1].reshape(B, H * W, 3)[:, ray_idx]
        mse = torch.mean((out["rgb"] - tgt) ** 2)
        return self.render_w * mse, mse

    def __call__(self, batch: Dict[str, torch.Tensor], block_ut: Optional[tuple] = None,
                 ray_idx: Optional[torch.Tensor] = None,
                 depth_rand: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        self.opt.zero_grad()
        loss, mse = self.loss(batch, block_ut, ray_idx, depth_rand)
        loss.backward()
        parts = torch.stack([mse.detach(), loss.detach()])
        if dist.is_initialized():
            mesh.average_gradients(self.model.parameters())
            if dist.process_count() > 1:
                mesh.all_reduce_mean(parts)
        self.opt.step()
        return {"render": parts[0], "all": parts[1]}


def make_train_step(cfg, model: MatchNeRF, opt: TrainOptimizer, img_h: int, img_w: int,
                    n_rays: int, kernel: bool = True,
                    generator: Optional[torch.Generator] = None,
                    mode: Optional[str] = None) -> TrainStep:
    return TrainStep(cfg, model, opt, img_h, img_w, n_rays, kernel, generator, mode)
