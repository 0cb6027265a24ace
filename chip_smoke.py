#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (matchnerf_tpu_torch): the DTU eval
render of configs/test.yaml, its fused-cosine route and its bf16 decoder
route, the video entry of configs/demo_own.yaml and of
configs/test_video_own.yaml, the training step and the training loop
(`python -m matchnerf_tpu_torch.train`) of configs/train.yaml and
configs/train_fast.yaml, and the eval entry (`python -m
matchnerf_tpu_torch.test`) of configs/test.yaml, test_video.yaml and
test_strict.yaml over DTU, LLFF and Blender test sets, on one NVIDIA card,
through the hand-written CUDA kernels.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases, any failure ends the run with a non-zero exit:
1. device: requires CUDA; prints the card (nvidia-smi name, power limit),
   torch and CUDA versions; builds the kernels from csrc/ (nvcc) and prints
   the build time. TF32 is switched off for matmuls and cuDNN, so every f32
   comparison is full f32.
2. scene: 4 cameras on an arc around the port's numpy raytracer scene
   (matchnerf_tpu_torch/data/synth.py), 640x512 images with DTU-like
   intrinsics and near/far; the model at full width (6 transformer layers,
   128 features, decoder width 128) from a seeded torch.Generator.
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, with max |d|, tolerance, CUDA-event times, the bound (the
   larger of bytes over 3.35 TB/s and operations over the peak rate of the
   input type; for the tensor-core kernels the route's tensor-core rate,
   split TF32 at 495/3 TFLOP/s or bf16 at 989: Kernels A and A', and Kernel
   C's wide products plus its rest over the 67 TFLOP/s of f32) and, for
   Kernels A and E, one PyTorch library call computing the same function
   (scaled_dot_product_attention, grid_sample): window attention on 24 x
   1280 x 128 windows (bf16 and f32), timed with and without the training
   forward's logsumexp, which is held against torch.logsumexp of the plain
   masked scores, beside SDPA's time, its max |d| against the plain version
   and the names of its kernels (torch.profiler); on a 20480-ray slice built
   from the encoder's real tables and the pose's real buckets, the per-ray
   cosine prior (B), the block-union cosine prior (D, also held against B,
   with its union sizes and buckets; it builds its unions itself, so one
   call runs no device kernel but D's, which the profiler must show, and
   only the plain twin's torch union build is timed apart), the supercell
   colour sample (E, which reads no union), and the decoder (C) on both
   operand routes (split TF32 against the f32 plain version at 1e-4 / 1e-3
   / 1e-4 for rgb / depth / opacity; bf16 against the bf16 plain twin at
   1e-2 / 1e-2 / 1e-3, with its mean |d| under a tenth of the mean gap
   between the two twins: a sum
   in another order flips the bf16 rounding of an activation now and
   then, and the rays that meet one set the max), and again
   at S=256 on a 5012-ray slice with configs/test_video_own.yaml's decoder;
   on the first 8192 rays (one chunk of the fused route), the fused interp
   + grouped cosine (F) on the tap rows of the int8 tables at both scales
   (also held against B) and of bf16 and f32 tables built from the same
   features, with the row gather timed apart; Kernels B and D on bf16
   tables built from the same features (configs/train.yaml's validation
   and test renders), at the eval slice and at the 4096-ray validation
   slice, against their plain twins at 1e-4 and D against B.
4. block path, configs/test.yaml as shipped: `Renderer.forward(batch,
   mode="test")` renders the full 640x512 target at S=128. The pose must
   take Kernel D at both scales and Kernel E for the colours; A, C, D and E
   must launch and no plain version may run on CUDA tensors; outputs
   finite, rgb in [0,1]; the same view with every kernel replaced by its
   plain version must agree at >= 50 dB PSNR.
5. per-ray path, block_kernel off: the same view through A, B and C (its
   f32 route only), which must each launch; it must agree with the block
   path at >= 60 dB. Then the same path with
   precision.decoder_matmul_dtype: bf16: C's bf16 route (only) must launch,
   and the image must agree with the all-plain bf16 render at >= 50 dB; its
   PSNR against the f32 image is printed.
6. fused path, configs/test.yaml with precision.fused_cosine: the same
   view with every feature scale through F (2 launches per slice), B and D
   never launched; it must agree with the block path at >= 60 dB. Then
   the f32 encoder of configs/test_strict.yaml (precision.strict): the
   scene's source views encoded through Kernel A's f32 route (12 launches
   of it and nothing else) and through the plain encoder, features within
   1e-4 (of the largest, at least 1), encode seconds of both.
7. video, configs/demo_own.yaml with precision.fused_cosine (the IBR
   decoder variant, S=128) at 256x160 on 3 source cameras of the synthetic
   scene: `Coach.test_model_video` renders the 24 frames of the interpolate
   path and writes them under build/chip_smoke/. A, C and F must launch (E
   on the frames whose colour union fits its bucket), B and D not, no plain
   version on CUDA; frames finite with rgb in [0,1]; frame 0 must agree
   with the all-plain frame at >= 50 dB. Prints frames/s and rays/s.
8. video, configs/test_video_own.yaml (S=256, 5012-ray slices) at 960x640
   on the synthetic scene (the card cannot decode the printer JPEGs): 3
   frames; A, B (2 per slice) and C (1 per slice) must launch and nothing
   else, no plain version on CUDA; frames finite with rgb in [0,1]; the
   first 2 slices of frame 0 must agree with all-plain at >= 50 dB.
9. training kernels at training shapes, each against autograd through its
   plain version, on the scene's real training rays (1024 random pixels,
   or 128 8-pixel strips for D'), stratified depths and the f32 tables of
   the bf16 training encoder: A' (window attention forward with logsumexp
   and backward, bf16 and f32, shifted and not; library yardstick SDPA
   with the float mask, its backward alone and forward + backward, with the
   names of its backward kernels), the B' table gradient per scale (and
   Kernel B's f32 forward at these shapes), D' f32 forward and backward
   per scale (also held against B and B', the same function; the largest
   training union is printed against its bucket). The A' backward also prints its TFLOP/s, counted as the
   function's 5 products (the kernels do 7); SDPA's backward, a call whose
   host work through autograd outlasts its kernels, is timed on the device
   (torch.profiler) beside its CUDA-event time.
10. configs/train.yaml step (`Coach.train_iteration`) on the 640x512 scene
   at full width, 1024 rays, S=128: a first step from one set of weights,
   rays and jitter through the kernels and all-plain (loss and per-tensor
   gradient error), with the recipe's bf16 policy and with the f32 policy;
   then 7 steps: finite losses, moving parameters, 12 A' forward, 12 A'
   backward, 2 B forward and 2 B' backward launches in each step and no
   plain version on CUDA tensors; ms per warm step and peak memory. After
   phase 11, 7 more train.yaml steps under the f32 policy (A and A' on
   their f32 route), checked and timed the same way.
11. configs/train_fast.yaml step: the same, with the pose's route through
   D' at both scales (2 D' forward and 2 D' backward launches per step).
12. the training loop: a synthetic DTU tree (6 views of the scene at
   640x512, PNGs written without PIL with each row's filter chosen as
   encoders choose it, so rows mix Up, Sub and Paeth, cameras with
   depth_min 425 and interval 2.5, 1200x1600 depth maps, its own meta
   dir); then per recipe (train.yaml, train_fast.yaml) the training CLI's
   `build_coach` and `train_model` for 4 steps of one epoch, validation and
   the mid-epoch checkpoint every 2 steps, the DTU test view and the epoch
   checkpoint; steps/s outside the hooks beside the loader's own seconds
   per sample: finite losses, `latest.ckpt` and `ep1_it4.ckpt`, PSNR and SSIM in
   scalars.jsonl, the table gradient through B' (train.yaml) or D'
   (train_fast.yaml) twice a step, no plain version on CUDA; one more
   validation image
   with its launches counted: Kernel D's bf16 form where the pose takes
   the block route (Kernel B's where a scale does not), no other table
   type; for train.yaml that image against the all-plain render (>= 50
   dB) and through Kernel B's bf16 form (block_kernel off) against the
   block route (>= 60 dB). Then `python -m matchnerf_tpu_torch.train` in a
   subprocess gets SIGTERM once its first mid-epoch checkpoint is on disk:
   exit 143 and `latest.ckpt` at an iteration inside the epoch; the resumed
   run (`--resume`) restores the model and the AdamW and schedule state
   bit for bit, starts at that iteration, skips the loaded batches and ends
   at the epoch's last. Steps per second (outside the hooks), validation
   seconds and peak memory are printed with the card's name and limit.
13. the eval entry: synthetic DTU (640x512), LLFF (960x640, eval_mode
   mvsnerf, forward-facing cameras) and Blender (800x800, RGBA with a real
   alpha) test trees, one target view each, written by data/synth.py with
   their own meta dirs; then `matchnerf_tpu_torch.test.main(["--config",
   "test", "--load=", "--data_test.tnt=", ...])` in this process at full
   width (6 transformer layers, decoder 128 x 6, S=128, seeded weights):
   per set A, C, D and E must launch (B too where a scale's union
   overflows its bucket, printed with the pose and scale), Kernel C with
   setbg on every Blender launch and nowhere else, no plain version on
   CUDA, rgb finite in [0,1], the whole image >= 50 dB against the
   all-plain render, the JAX package's output files; the render seconds,
   rays/s, route per scale, launches, and each eval kernel's device ms and
   launches in one more (profiled) render of the set (Kernel A's windows
   are L = 1280, 2400 and 2500 tokens; D's scale-1 tables 160x128,
   240x160 and 200x200 cells). Then `--config test_video` (3 frames) on
   the LLFF tree (the spiral) and the Blender tree (interpolated, white
   background), frame 0 >= 50 dB against all-plain; then `--config
   test_strict` on the DTU tree: Kernel A's f32 route (12 launches), the
   cond query and decoder in torch ops (their plain versions on CUDA, as
   precision.strict asks), finite, its PSNR against the shipped-config
   render printed. The T&T set is left out: its JPEGs need PIL.
Every launch count is reset just before a path (a step, in 10 and 11; a
training run and a validation image, in 12; each test set's render, in
13) and read just after it. With --profile, one more warm render of each eval path
(the bf16 decoder path too) and of each video, and one warm step of each
training recipe run under torch.profiler and print the device time by
kernel (the A' backward's dq and dkv kernels always by name), the device
busy time and the wall time.
The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
import argparse
import copy
import json
import math
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
H, W = 512, 640
DTU_NEAR_FAR = (2.125, 4.525)
SLICE_RAYS = 20480
VAL_RAYS = 4096                    # configs/train.yaml nerf.rand_rays_test (val and test renders)
TRAIN_RAYS = 1024
TRAIN_STEPS = 7                    # steps per recipe; the first is warm-up
VIDEO_FRAMES = 24                  # configs/demo_own.yaml nerf.video_n_frames
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, f32 without tensor cores
# the tensor-core rate of a kernel's operand route (Kernel C's wide products,
# Kernels A and A'): bf16 at the bf16 peak; split TF32 takes three TF32
# products (495 TFLOP/s) for each f32 one
TC_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
OWN_FRAMES = 3                     # frames of the configs/test_video_own.yaml phase
OWN_PLAIN_SLICES = 2               # slices of its frame 0 held to all-plain
LOOP_STEPS = 4                     # training steps per recipe in the loop phase
PREEMPT_STEPS = 8                  # steps of the run that is sent SIGTERM
PROFILE_PAD_S = 0.005              # idle host seconds at each end of a kernel trace


def log(msg):
    print(msg, flush=True)


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters):
    """Mean milliseconds per call from CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Mean device milliseconds per call: the summed time of the kernels
    `fn` launches (torch.profiler), after two warm-up calls. For a call
    whose host work outlasts its kernels, where CUDA events around a run of
    calls measure the host."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_time_total > 0) / 1e3 / iters


def kernel_names(torch, fn, iters=3, attempts=3):
    """The names of the device kernels `fn` runs (torch.profiler). The calls
    sit inside the traced window with PROFILE_PAD_S of idle host time at
    both ends, and a trace that recorded no device kernel at all is taken
    again, up to `attempts` times: the profiler can come back empty for a
    window that holds only a kernel or two of well under a millisecond."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        names = sorted({e.key[:120] for e in prof.key_averages()
                        if e.device_type.name == "CUDA" and e.device_time_total > 0})
        if names:
            return names
        log(f"torch.profiler recorded no device kernel in trace {attempt} of {attempts}")
    return []


def only_kernel(torch, fn, name):
    """The device kernels three calls of `fn` run; fails unless there is one
    and every one is the named kernel (a wrapper that launches nothing but
    its kernel)."""
    names = kernel_names(torch, fn)
    if not names or any(name not in k for k in names):
        raise AssertionError(f"{name}: the call ran {names}, not only its kernel")
    return names


def bound(nbytes, flops, dtype="float32", rates=PEAK_FLOPS):
    """(bound ms, 'bytes' or 'operations'): the least time for the work,
    its operations at rates[dtype]."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rates[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def prior_flops(n_samples, scaled):
    """Operations of Kernel B / D's function: 7 flops per (sample, view,
    channel) for the four bilinear taps (4 multiplies, 3 adds), one more to
    dequantise rows that carry a scale (int8), and 6 per (sample, pair,
    chunk channel) for the grouped cosine."""
    return n_samples * (3 * 256 * (7 + bool(scaled)) + 3 * 128 * 6)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def make_scene(seed):
    """4 posed 640x512 views of the synthetic scene; the last is the target."""
    from matchnerf_tpu_torch.data import synth
    rng = np.random.default_rng(seed)
    radius = 3.7
    angles = np.deg2rad([-16.0, 0.0, 16.0, 8.0]) + rng.uniform(-0.02, 0.02, 4)
    eyes = [(radius * math.sin(a), -1.0, -radius * math.cos(a)) for a in angles]
    views = synth.make_scene_views(W, H, focal=1.8 * W, eyes=eyes)
    near_fars = np.tile(np.asarray(DTU_NEAR_FAR, np.float32), (4, 1))
    return {"images": views["images"][None],
            "extrinsics": views["w2cs"][None],
            "intrinsics": views["intrinsics"][None],
            "near_fars": near_fars[None]}


def psnr(a, b):
    """PSNR in dB on the [0, 1] scale; identical images give 999.0 (a
    number that strict JSON readers accept)."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 999.0 if mse == 0.0 else -10.0 * math.log10(mse)


def profile_call(torch, name, fn, top=12, keep=()):
    """One warm call of `fn` under torch.profiler: device time by kernel
    (top `top`, and every kernel whose name contains one of `keep`), summed
    device time, and the wall time around it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    if not rows:       # older profilers report device time on the CPU-side ops
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    n_ops = sum(r[2] for r in rows)
    log(f"profile {name}: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100.0 * (1.0 - busy / (wall * 1e3)):.1f} % idle), {n_ops} device operations")
    shown = rows[:top] + [r for r in rows[top:] if any(k in r[0] for k in keep)]
    for key, ms, count in shown:
        log(f"profile {name}:   {ms:9.2f} ms  {count:5d}x  {key[:100]}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy, "device_ops": n_ops,
            "top": [[k[:100], ms, c] for k, ms, c in shown]}


def check_close(name, err, tol):
    if not err <= tol:
        raise AssertionError(f"{name}: max|d| {err} > {tol}")


def max_abs(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def grad_errors(model_a, model_b):
    """Per parameter tensor, ||grad_a - grad_b|| / ||grad_b|| in float64,
    the denominator floored at 1e-3 of the largest gradient norm."""
    pairs = [(n, pa.grad.double(), pb.grad.double())
             for (n, pa), (_, pb) in zip(model_a.named_parameters(), model_b.named_parameters())]
    floor = 1e-3 * max(float(gb.norm()) for _, _, gb in pairs)
    return {n: float((ga - gb).norm()) / max(float(gb.norm()), floor) for n, ga, gb in pairs}


def decoder_flops(dec, S):
    """Kernel C's operations per sample: (the wide products, 2 per weight of
    pts_bias, the pts_linears, alpha_linear, feature_linear, views_linears.0
    and rgb_linear; the f32 remainder, 2 per weight of w_qs, w_ks, w_vs, fc
    and out_alpha_linear, the ray attention's QK and PV over S samples and
    the 60 sin/cos of the encoding)."""
    wide = [dec.pts_bias, *dec.pts_linears, dec.alpha_linear[0], dec.feature_linear,
            dec.views_linears[0], dec.rgb_linear]
    ra = dec.ray_attention
    rest = [ra.w_qs, ra.w_ks, ra.w_vs, ra.fc, dec.out_alpha_linear[0], dec.out_alpha_linear[2]]
    return (2 * sum(m.weight.numel() for m in wide),
            2 * sum(m.weight.numel() for m in rest) + 4 * S * 16 + 60)


def decoder_bound(nbytes_, dec, N, S, route):
    """Kernel C's bound on one route for N samples on rays of S: the wide
    products over the route's tensor-core rate plus the remainder over the
    f32 CUDA-core rate, against the bytes over the memory rate."""
    wide, rest = decoder_flops(dec, S)
    t_ops = (N * wide / TC_FLOPS[route] + N * rest / PEAK_FLOPS["float32"]) * 1e3
    t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decoder_case(torch, kc, dev, args, label):
    """Kernel C on both operand routes against its plain twins on one slice:
    max |d| per output and tolerance, for bf16 also the mean |d| against a
    tenth of the mean gap between the f32 and bf16 twins; CUDA-event times
    and the per-route bound."""
    dec = args[0]
    R, S = args[2].shape[1], args[2].shape[2]
    N = R * S                                   # samples
    ins = [args[2], args[3], *args[4].values(), args[5], args[6]]
    out = {}
    with torch.no_grad():
        twins = {r: kc.cond_nerf_decode_plain(*args, matmul_dtype=getattr(torch, r))
                 for r in ("float32", "bfloat16")}
        gap = float(torch.cat([(a - b).abs().flatten() for a, b in
                               zip(twins["float32"], twins["bfloat16"])]).mean())
        # bf16: a product summed in another order than the twin's rounds an
        # activation to the neighbouring bf16 value now and then; the few
        # rays that meet such flips set the max, the mean |d| (held under a
        # tenth of the twins' gap) shows the function
        for route, tols in (("float32", (1e-4, 1e-3, 1e-4)), ("bfloat16", (1e-2, 1e-2, 1e-3))):
            md = getattr(torch, route)
            got = kc.cond_nerf_decode(*args, matmul_dtype=md)
            ref = twins[route]
            torch.cuda.synchronize()
            errs = [max_abs(g, r) for g, r in zip(got, ref)]
            diffs = torch.cat([(g - r).abs().flatten() for g, r in zip(got, ref)])
            mean_err = float(diffs.mean())
            n_over = int((diffs > 1e-3).sum())
            ms = cuda_ms(torch, lambda: kc.cond_nerf_decode(*args, matmul_dtype=md), 10)
            plain_ms = cuda_ms(torch, lambda: kc.cond_nerf_decode_plain(*args, matmul_dtype=md), 3)
            small, frag = kc.kernel_weights(dec, md, dev)
            wide, rest = decoder_flops(dec, S)
            b_ms, b_by = decoder_bound(nbytes(*ins, *got, small, frag), dec, N, S, route)
            log(f"kernel C cond_nerf_decode {label} R={R} S={S} {route} route: max|d| rgb "
                f"{errs[0]:.3e} depth {errs[1]:.3e} opacity {errs[2]:.3e} (tol {tols}), {n_over} "
                f"of {diffs.numel()} above 1e-3, mean|d| {mean_err:.3e} (f32 vs bf16 twins "
                f"{gap:.3e}), {ms:.3f} ms vs plain "
                f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}: {N * wide / 1e12:.3f} TFLOP "
                f"of wide products at {TC_FLOPS[route] / 1e12:.0f} TFLOP/s + "
                f"{N * rest / 1e12:.4f} TFLOP at 67)")
            for name, err, tol in zip(("rgb", "depth", "opacity"), errs, tols):
                check_close(f"cond_nerf_decode {label} {route} {name}", err, tol)
            if route == "bfloat16" and not mean_err < 0.1 * gap:
                raise AssertionError(f"cond_nerf_decode {label} bf16: mean|d| {mean_err} is not "
                                     f"under a tenth of the f32-bf16 gap {gap}")
            out[route] = dict(R=R, S=S, max_abs_err=max(errs), max_abs_err_rgb_depth_opacity=errs,
                              tol=list(tols), mean_abs_err=mean_err, n_above_1e3=n_over,
                              twin_gap_mean=gap, ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            del got
    return out


def train_kernel_phase(torch, F, dev, batch, seed, block_ut, res):
    """Phase 9: A', B' and D' at the training shapes against autograd
    through their plain versions."""
    from matchnerf_tpu_torch import camera
    from matchnerf_tpu_torch.config import dtu_train_config
    from matchnerf_tpu_torch.models.matchnerf import (encode, init_matchnerf,
                                                      prepare_sampling_tables,
                                                      project_to_views, sample_depth)
    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.ops import window_attention as ka
    from matchnerf_tpu_torch.ops.attention import shift_region_ids
    from matchnerf_tpu_torch.renderer import Renderer, extract_poses
    from matchnerf_tpu_torch.train_step import sample_ray_indices

    grad = torch.autograd.grad
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    # A': 24 windows (2 streams x 3 pairs x 2x2 splits) of the 1/8-scale map
    h8, w8 = H // 8, W // 8
    BW, L = 24, h8 * w8 // 4
    rid = shift_region_ids(h8, w8, 2, device=dev)
    rows = rid[torch.arange(BW, device=dev) % rid.shape[0]]
    res["A_bwd"] = {}
    prod = 2 * BW * L * L * 128                  # flops of one score-sized product
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        name = str(dt).replace("torch.", "")
        for shift in (False, True):
            r = rid if shift else None
            q, k, v, do = (torch.randn(BW, L, 128, generator=gen, device=dev).to(dt)
                           for _ in range(4))
            qk = [t.clone().requires_grad_() for t in (q, k, v)]
            qp = [t.clone().requires_grad_() for t in (q, k, v)]
            out = ka.window_attention(*qk, r)
            outp = ka.window_attention_plain(*qp, r)
            gk = grad(out, qk, do, retain_graph=True)
            gp = grad(outp, qp, do, retain_graph=True)
            torch.cuda.synchronize()
            err = max(max_abs(a, b) for a, b in zip(gk, gp))
            tol_abs = tol * max(float(b.float().abs().max()) for b in gp)
            err_out = max_abs(out, outp)
            fwd_ms = cuda_ms(torch, lambda: ka.window_attention(*qk, r), 10)
            # the backward kernels timed alone; through autograd the host's
            # own time per call comes near the kernels' and is timed apart
            o, lse = out.detach(), ka.window_attention_forward(q, k, v, r, with_lse=True)[1]
            ms = cuda_ms(torch, lambda: ka.window_attention_backward(q, k, v, o, lse, do, r), 20)
            autograd_ms = cuda_ms(torch, lambda: grad(out, qk, do, retain_graph=True), 10)
            plain_ms = cuda_ms(torch, lambda: grad(outp, qp, do, retain_graph=True), 5)
            ql = [t[:, None].detach().clone().requires_grad_() for t in (q, k, v)]
            mask = None
            if shift:
                mask = torch.where(rows[:, :, None] != rows[:, None, :], -100.0, 0.0)
                mask = mask[:, None].to(dt)
            outl = F.scaled_dot_product_attention(*ql, attn_mask=mask)
            gl = grad(outl, ql, do[:, None], retain_graph=True)
            lib_err = max(max_abs(a[:, 0], b) for a, b in zip(gl, gp))
            # the library's backward through autograd: the host's time per
            # call is near its kernels', so its device time is the yardstick
            lib_bwd = lambda: grad(outl, ql, do[:, None], retain_graph=True)
            lib_ms = device_ms(torch, lib_bwd, 10)
            lib_events_ms = cuda_ms(torch, lib_bwd, 10)
            lib_kernels = kernel_names(torch, lib_bwd)
            # forward + backward together, the kernels' and the library's
            fb_ms = cuda_ms(torch, lambda: ka.window_attention_backward(
                q, k, v, *ka.window_attention_forward(q, k, v, r, with_lse=True), do, r), 20)
            lib_fb_ms = device_ms(torch, lambda: grad(
                F.scaled_dot_product_attention(*ql, attn_mask=mask), ql, do[:, None]), 10)
            b_ms, b_by = bound(nbytes(q, k, v, out, do, lse, *gk), 5 * prod, name, TC_FLOPS)
            tag = f"{name}_{'shift' if shift else 'noshift'}"
            tflops = 5 * prod / ms / 1e9             # the function's 5 products
            log(f"kernel A' window_attention backward {name} [{BW},{L},128] "
                f"{'shift-masked' if shift else 'unmasked'}: max|d| dq/dk/dv {err:.3e} "
                f"(tol {tol_abs:.3e}), out {err_out:.3e}; forward with logsumexp "
                f"{fwd_ms:.3f} ms; backward {ms:.4f} ms ({tflops:.1f} TFLOP/s, 5 products; "
                f"through autograd {autograd_ms:.4f} ms) vs plain {plain_ms:.3f} ms, "
                f"library SDPA backward {lib_ms:.4f} ms on the device (CUDA events around "
                f"the autograd call {lib_events_ms:.4f} ms; max|d| {lib_err:.3e}); forward + "
                f"backward {fb_ms:.3f} ms vs SDPA {lib_fb_ms:.3f} ms on the device; bound "
                f"{b_ms:.4f} ms ({b_by}, 5 products at {TC_FLOPS[name] / 1e12:.0f} TFLOP/s); "
                f"SDPA's backward kernels {lib_kernels}")
            check_close(f"window_attention backward {tag}", err, tol_abs)
            res["A_bwd"][tag] = dict(max_abs_err=err, tol=tol_abs, ms=ms, tflops=tflops,
                                     autograd_ms=autograd_ms, fwd_ms=fwd_ms,
                                     plain_ms=plain_ms, library_ms=lib_ms,
                                     library_events_ms=lib_events_ms,
                                     library_max_abs_err=lib_err, library_kernels=lib_kernels,
                                     fwd_bwd_ms=fb_ms,
                                     library_fwd_bwd_ms=lib_fb_ms, bound_ms=b_ms,
                                     bound_by=b_by)
            del q, k, v, do, qk, qp, out, outp, gk, gp, ql, outl, gl, mask, o, lse, lib_bwd

    # B' and D' on the scene's training rays with the training f32 tables
    tcfg = dtu_train_config()
    tmodel = init_matchnerf(tcfg, torch.Generator().manual_seed(seed)).to(dev)
    r0 = Renderer(tcfg, tmodel, dev)
    ref_images = r0.tensor(batch["images"][:, :3])
    with torch.no_grad():
        ttables = prepare_sampling_tables(tcfg, encode(tmodel, tcfg, ref_images), ref_images)
    poses = extract_poses(batch)
    tgt_intr, c2w, tgt_nf, ref_w2c, ref_intr, ref_nf = r0._pose_tensors(poses)
    R = TRAIN_RAYS

    def train_grids(patches):
        idx = sample_ray_indices(H * W, R, patches, dev, gen)
        pix = torch.stack([(idx % W).float(), (idx // W).float()], -1)[None]
        center, ray = camera.get_center_and_ray(pix, tgt_intr, c2w)
        depth = sample_depth(tcfg, tgt_nf, 1, R, stratified=True, generator=gen)
        pts = camera.get_3d_points_from_depth(center, ray, depth, multi_samples=True)
        return (project_to_views(pts, ref_w2c, ref_intr, ref_nf, H, W)[..., :2]
                * 2.0 - 1.0)[:, 0].contiguous()

    grids_ray, grids_strip = train_grids(False), train_grids(True)
    S = grids_ray.shape[2]
    N = R * S
    for key in ("B_f32", "B_bwd", "D_f32", "D_bwd"):
        res[key] = []
    for s, G in enumerate(tcfg.encoder.cos_n_group):
        table = ttables["view_feats"][s][0]
        h, w = table.shape[1:3]
        gcot = torch.randn(R, S, G, generator=gen, device=dev)
        fwd_flops = prior_flops(N, scaled=False)          # f32 tables
        bwd_flops = N * (3 * 256 * 16 + 3 * 128 * 12)
        bwd_bound = bound(2 * nbytes(table) + nbytes(grids_ray, gcot), bwd_flops)

        def backward_pair(fn_k, fn_p, grids):
            tk = table.clone().requires_grad_()
            tp = table.clone().requires_grad_()
            ok, op = fn_k(tk, grids), fn_p(tp, grids)
            dk, dp = grad(ok, tk, gcot, retain_graph=True)[0], grad(op, tp, gcot,
                                                                  retain_graph=True)[0]
            torch.cuda.synchronize()
            err = max_abs(dk, dp)
            tol = 1e-5 * float(dp.abs().max())
            ms = cuda_ms(torch, lambda: grad(ok, tk, gcot, retain_graph=True), 10)
            plain_ms = cuda_ms(torch, lambda: grad(op, tp, gcot, retain_graph=True), 3)
            return dk, err, tol, ms, plain_ms

        # Kernel B's f32 forward at the training shapes (the forward of B')
        with torch.no_grad():
            fb = lambda: kb.cosine_prior(table, grids_ray, None, G)
            fbp = lambda: kb.cosine_prior_plain(table, grids_ray, None, G)
            out_b = fb()
            err = max_abs(out_b, fbp())
            b_ms, b_by = bound(nbytes(table, grids_ray, out_b), fwd_flops)
            res["B_f32"].append(dict(scale=s, max_abs_err=err, ms=cuda_ms(torch, fb, 10),
                                     plain_ms=cuda_ms(torch, fbp, 3), bound_ms=b_ms,
                                     bound_by=b_by))
        check_close(f"B f32 forward scale {s}", err, 1e-5)
        dk_b, err, tol, ms, plain_ms = backward_pair(
            lambda t, g_: kb.cosine_prior(t, g_, None, G),
            lambda t, g_: kb.cosine_prior_plain(t, g_, None, G), grids_ray)
        log(f"kernel B cosine_prior f32 forward scale {s} table {list(table.shape)} G={G} "
            f"R={R} S={S}: max|d| {res['B_f32'][-1]['max_abs_err']:.3e} (tol 1e-5), "
            f"{res['B_f32'][-1]['ms']:.3f} ms vs plain {res['B_f32'][-1]['plain_ms']:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        log(f"kernel B' cosine_prior backward scale {s}: max|d| d_table {err:.3e} (tol "
            f"{tol:.3e}), {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
            f"{bwd_bound[0]:.4f} ms ({bwd_bound[1]})")
        check_close(f"B' scale {s}", err, tol)
        res["B_bwd"].append(dict(scale=s, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bwd_bound[0], bound_by=bwd_bound[1]))

        # D' on the 8-pixel strips: the pose's bucket, the training union
        ut = block_ut[s]
        if not kd.takes_f32(ut, S, G):
            raise AssertionError(f"D' does not take ut={ut} G={G} S={S}")
        gp = kd.pad_rays(grids_strip)
        union = kd.block_union_size_raw(gp, h, w)
        with torch.no_grad():
            fd = lambda: kd.block_cosine_prior(table, grids_strip, None, G, ut)
            fdp = lambda: kd.block_cosine_prior_plain(table, grids_strip, None, G, ut)
            out_d = fd()
            err = max_abs(out_d, fdp())
            err_b = max_abs(out_d, kb.cosine_prior(table, grids_strip, None, G))
            d_ms, d_by = bound(nbytes(table, grids_strip, out_d), fwd_flops)
            entry = dict(scale=s, max_abs_err=err, max_abs_err_vs_kernel_b=err_b,
                         ms=cuda_ms(torch, fd, 10), plain_ms=cuda_ms(torch, fdp, 3),
                         plain_union_ms=cuda_ms(torch, lambda: kd.block_unions(gp, h, w, ut),
                                                10),
                         bound_ms=d_ms, bound_by=d_by, ut=ut, train_union_size=union)
        log(f"kernel D' block_cosine_prior f32 forward scale {s} G={G} R={R} S={S} (strips): "
            f"training union {union} rows vs bucket {ut} (pose_prep, eval-spaced "
            f"depths){' OVERFLOW: missing taps add 0' if union > ut else ''}; max|d| "
            f"{err:.3e} (tol 1e-5), vs kernel B {err_b:.3e} (tol 1e-5), {entry['ms']:.3f} ms "
            f"(the kernel builds its union; the plain twin's torch build "
            f"{entry['plain_union_ms']:.3f} ms) vs plain {entry['plain_ms']:.3f} ms, bound "
            f"{d_ms:.4f} ms ({d_by})")
        check_close(f"D' forward scale {s}", err, 1e-5)
        check_close(f"D' vs B forward scale {s}", err_b, 1e-5)
        res["D_f32"].append(entry)
        dk_d, err, tol, ms, plain_ms = backward_pair(
            lambda t, g_: kd.block_cosine_prior(t, g_, None, G, ut),
            lambda t, g_: kd.block_cosine_prior_plain(t, g_, None, G, ut), grids_strip)
        tk = table.clone().requires_grad_()
        dk_b = grad(kb.cosine_prior(tk, grids_strip, None, G), tk, gcot)[0]
        err_b = max_abs(dk_d, dk_b) if union <= ut else None
        log(f"kernel D' block_cosine_prior backward scale {s}: max|d| d_table {err:.3e} "
            f"(tol {tol:.3e}), vs kernel B' {err_b if err_b is None else f'{err_b:.3e}'}, "
            f"{ms:.3f} ms vs plain {plain_ms:.3f} ms, bound {bwd_bound[0]:.4f} ms "
            f"({bwd_bound[1]})")
        check_close(f"D' backward scale {s}", err, tol)
        if err_b is not None:
            check_close(f"D' vs B' backward scale {s}", err_b, tol)
        res["D_bwd"].append(dict(scale=s, max_abs_err=err, tol=tol, max_abs_err_vs_kernel_b=err_b,
                                 ms=ms, plain_ms=plain_ms, bound_ms=bwd_bound[0],
                                 bound_by=bwd_bound[1]))
        del table, out_b, out_d, dk_b, dk_d
    del tmodel, ttables


def first_step_check(torch, dev, cfg, batch, seed, label, tol):
    """One step's loss and gradients from one set of weights, rays and
    jitter, through the kernels and all-plain; tol = (loss rtol, worst and
    median per-tensor gradient error)."""
    from matchnerf_tpu_torch.engine import Coach
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    from matchnerf_tpu_torch.train_step import sample_ray_indices
    model_k = init_matchnerf(cfg, torch.Generator().manual_seed(seed)).to(dev)
    model_p = copy.deepcopy(model_k)
    coaches = []
    for m, kern in ((model_k, True), (model_p, False)):
        c = Coach(cfg, m, dev, kernel=kern)
        c.setup_optimizer(TRAIN_STEPS)
        coaches.append(c)
    route = coaches[0].train_route(batch)
    bt = coaches[0].batch_tensors(batch)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    patches = bool(cfg.nerf.get("train_ray_patches", False))
    S = int(cfg.nerf.sample_intvs)
    idx = sample_ray_indices(H * W, TRAIN_RAYS, patches, dev, gen)
    rand = torch.rand((1, TRAIN_RAYS, S, 1), generator=gen, device=dev)
    losses = []
    for c in coaches:
        loss, _ = c.step.loss(bt, route, idx, rand)
        loss.backward()
        losses.append(float(loss.detach()))
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    errs = grad_errors(model_k, model_p)
    worst = max(errs, key=errs.get)
    med = float(np.median(list(errs.values())))
    log(f"{label}: first step kernels vs all-plain: loss {losses[0]:.7f} vs {losses[1]:.7f} "
        f"(rel {loss_rel:.3e}, tol {tol[0]:g}); gradient error per tensor: worst "
        f"{errs[worst]:.3e} ({worst}), median {med:.3e} (tol {tol[1]:g} / {tol[2]:g}), "
        f"{len(errs)} tensors")
    if not (loss_rel <= tol[0] and errs[worst] <= tol[1] and med <= tol[2]):
        raise AssertionError(f"{label}: kernel step disagrees with the all-plain step")
    return {"loss_rel": loss_rel, "grad_err_worst": errs[worst], "grad_err_worst_tensor": worst,
            "grad_err_median": med, "tol": list(tol)}


def train_path(torch, dev, cfg, batch, seed, label, counters, must, profile):
    """Phases 10 and 11: TRAIN_STEPS steps of `Coach.train_iteration`; counts
    reset before and read after each step."""
    from matchnerf_tpu_torch.engine import Coach
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    model = init_matchnerf(cfg, torch.Generator().manual_seed(seed)).to(dev)
    coach = Coach(cfg, model, dev)
    coach.setup_optimizer(1000)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, launches, plain, events = [], [], [], []
    t0 = None
    for i in range(TRAIN_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        for c in counters.values():
            c.reset()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        loss = coach.train_iteration(batch)
        e1.record()
        launches.append({k: c.launches for k, c in counters.items()})
        plain.append({k: c.plain_on_cuda for k, c in counters.items()})
        losses.append(loss["all"])
        events.append((e0, e1))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (TRAIN_STEPS - 1)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(l) for l in losses]
    log(f"{label}: route {coach.last_route} (None: Kernel B'), losses "
        f"{[round(l, 6) for l in losses]}")
    log(f"{label}: ms per step (CUDA events) {[round(t, 3) for t in step_ms]}, warm mean "
        f"{float(np.mean(step_ms[1:])):.3f} ms, host wall {wall_ms:.3f} ms per warm step, "
        f"peak device memory {peak_gib:.2f} GiB")
    log(f"{label}: launches per step {launches[-1]}, plain versions on CUDA {plain[-1]}")
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    for group in ("feat_enc", "nerf_dec"):
        if not any(not torch.equal(p.detach(), start[n]) for n, p in model.named_parameters()
                   if n.startswith(group)):
            raise AssertionError(f"{label}: {group} parameters did not move")
    for i, (l, pc) in enumerate(zip(launches, plain)):
        for k, want in must.items():
            if l[k] != want:
                raise AssertionError(f"{label} step {i}: {k} launched {l[k]} times, "
                                     f"expected {want}")
        if any(pc.values()):
            raise AssertionError(f"{label} step {i}: plain versions ran on CUDA: {pc}")
    out = {"step_ms": step_ms, "warm_step_ms": float(np.mean(step_ms[1:])),
           "wall_ms_per_warm_step": wall_ms, "peak_gib": peak_gib, "losses": losses,
           "route": coach.last_route, "launches_per_step": launches[-1],
           "launches_total": {k: sum(l[k] for l in launches) for k in counters}}
    if profile:
        # the A' backward's two kernels by name, whatever their rank
        out["profile"] = profile_call(torch, label, lambda: coach.train_iteration(batch),
                                      keep=("window_attention_dq", "window_attention_dkv"))
    return out


def strict_encode_phase(torch, model, cfg, ref_images, counters):
    """Phase 6, the f32 encode of configs/test_strict.yaml (precision.strict
    makes the encoder f32): one warm encode of the scene's source views
    through Kernel A's f32 route, counted, and through the plain encoder;
    the features against the plain ones and the encode seconds (host clock
    around a synchronised call, mean of 3)."""
    from matchnerf_tpu_torch.models.matchnerf import encode
    from matchnerf_tpu_torch.ops import window_attention as ka

    def run(kernel, n=3):
        seconds = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                feats = encode(model, cfg, ref_images, kernel=kernel)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        return feats, float(np.mean(seconds))

    run(True, 1)                                   # warm
    for c in counters.values():
        c.reset()
    feats, enc_s = run(True, 1)
    routes = dict(ka.COUNTER.by_entry)
    launches = {k: c.launches for k, c in counters.items()}
    plain_cuda = {k: c.plain_on_cuda for k, c in counters.items()}
    _, enc_s = run(True)
    ref, plain_s = run(False)
    err = max(max_abs(a, b) for a, b in zip(feats, ref))
    tol = 1e-4 * max(1.0, max(float(r.abs().max()) for r in ref))
    log(f"strict f32 encode (configs/test_strict.yaml, encoder f32): {enc_s:.4f} s through "
        f"the kernels vs {plain_s:.4f} s plain; Kernel A launches by route {routes}; max|d| "
        f"features vs plain {err:.3e} (tol {tol:.3e}); scales "
        f"{[list(f.shape) for f in feats]}")
    if routes != {"window_attention_f32": 12} or sum(launches.values()) != 12:
        raise AssertionError(f"strict f32 encode: launches {launches}, Kernel A routes {routes}; "
                             "expected 12 f32 launches of Kernel A and nothing else")
    if any(plain_cuda.values()):
        raise AssertionError(f"strict f32 encode: plain versions ran on CUDA: {plain_cuda}")
    if not all(bool(torch.isfinite(f).all()) for f in feats):
        raise AssertionError("strict f32 encode: non-finite features")
    check_close("strict f32 encode features", err, tol)
    return {"encode_s": enc_s, "plain_encode_s": plain_s, "max_abs_err": err, "tol": tol,
            "launches": routes}


def fused_kernel_phase(torch, cfg, feats, ref_images, tables, grids, res):
    """Phase 3, Kernel F: on the first FUSED_CHUNK_RAYS rays of `grids` (one
    chunk of the fused route), the tap rows of the int8 tables (also held
    against Kernel B) and of bf16 and f32 tables from the same features."""
    from matchnerf_tpu_torch.models.matchnerf import (FUSED_CHUNK_RAYS, gather_tap_rows,
                                                      prepare_sampling_tables)
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.ops import fused_cosine as kf
    R = FUSED_CHUNK_RAYS
    g = grids[:, :R].contiguous()
    S = g.shape[2]
    N = R * S
    by_dtype = [("int8", tables)]
    for dt in (torch.bfloat16, None):
        by_dtype.append((str(dt or torch.float32).replace("torch.", ""),
                         prepare_sampling_tables(cfg, feats, ref_images, feat_dtype=dt)))
    res["F"] = {}
    for name, tabs in by_dtype:
        res["F"][name] = []
        for s, G in enumerate(cfg.encoder.cos_n_group):
            table = tabs["view_feats"][s][0]
            scales = tabs["view_feat_scales"][s]
            scales = None if scales is None else scales[0]
            rows, wts = gather_tap_rows(table, g)
            fn = lambda: kf.fused_interp_grouped_cosine(rows, wts, G, scales)
            plain = lambda: kf.fused_interp_grouped_cosine_plain(rows, wts, G, scales)
            got = fn()
            err = max_abs(got, plain())
            torch.cuda.synchronize()
            # per (view, channel) 9 flops to lerp 4 taps (+1 to dequantise);
            # per (pair, chunk channel) 6 for the dot product and two norms
            flops = N * (3 * 256 * (9 + (scales is not None)) + 3 * 128 * 6)
            b_ms, b_by = bound(nbytes(rows, wts, got, *([scales] if scales is not None
                                                          else [])), flops)
            entry = dict(scale=s, max_abs_err=err, ms=cuda_ms(torch, fn, 10),
                         plain_ms=cuda_ms(torch, plain, 3), bound_ms=b_ms, bound_by=b_by,
                         gather_ms=cuda_ms(torch, lambda: gather_tap_rows(table, g), 5),
                         rows_gb=nbytes(rows) / 1e9)
            extra = ""
            if name == "int8":
                entry["max_abs_err_vs_kernel_b"] = max_abs(
                    got, kb.cosine_prior(table, g, scales, G).reshape(N, G))
                extra = f", max|d| vs kernel B {entry['max_abs_err_vs_kernel_b']:.3e} (tol 1e-5)"
            log(f"kernel F fused_cosine scale {s} {name} rows [3,{N},{rows.shape[2]}] "
                f"({entry['rows_gb']:.2f} GB) G={G} R={R} S={S}: max|d| {err:.3e} (tol 1e-5)"
                f"{extra}, {entry['ms']:.3f} ms vs plain {entry['plain_ms']:.3f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}); the torch row gather {entry['gather_ms']:.3f} ms")
            check_close(f"F {name} scale {s}", err, 1e-5)
            if name == "int8":
                check_close(f"F vs B scale {s}", entry["max_abs_err_vs_kernel_b"], 1e-5)
            res["F"][name].append(entry)
            del rows, wts, got
        del tabs
    torch.cuda.empty_cache()


def bf16_kernel_phase(torch, cfg, feats, ref_images, grids, block_ut, res):
    """Phase 3, Kernels B and D on bf16 tables (base.yaml's
    cond_sample_dtype, the eval renders of configs/train.yaml) built from
    the same features: each scale at the eval slice (20480 rays) and the
    validation slice of configs/train.yaml (nerf.rand_rays_test, 4096 rays)
    against its plain twin (1e-4, as on int8 tables), D also against B."""
    from matchnerf_tpu_torch.models.matchnerf import prepare_sampling_tables
    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    tables = prepare_sampling_tables(cfg, feats, ref_images, feat_dtype=torch.bfloat16)
    res["B_bf16"], res["D_bf16"] = [], []
    for R in (SLICE_RAYS, VAL_RAYS):
        g = grids[:, :R].contiguous()
        S = g.shape[2]
        N = R * S
        for s, G in enumerate(cfg.encoder.cos_n_group):
            table = tables["view_feats"][s][0]
            ut = block_ut[s]
            out_b = kb.cosine_prior(table, g, None, G)
            flops = prior_flops(N, scaled=False)          # bf16 rows have no scales
            b_ms, b_by = bound(nbytes(table, g, out_b), flops)
            for key, fn, plain in (
                    ("B", lambda: kb.cosine_prior(table, g, None, G),
                     lambda: kb.cosine_prior_plain(table, g, None, G)),
                    ("D", lambda: kd.block_cosine_prior(table, g, None, G, ut),
                     lambda: kd.block_cosine_prior_plain(table, g, None, G, ut))):
                got = fn()
                err = max_abs(got, plain())
                torch.cuda.synchronize()
                entry = dict(scale=s, R=R, max_abs_err=err, ms=cuda_ms(torch, fn, 10),
                             plain_ms=cuda_ms(torch, plain, 3), bound_ms=b_ms, bound_by=b_by)
                extra = ""
                if key == "D":
                    entry["ut"] = ut
                    entry["channels_per_pass"] = kd.channels_per_pass(ut, S, G, False, 2)
                    entry["max_abs_err_vs_kernel_b"] = max_abs(got, out_b)
                    entry["device_kernels"] = only_kernel(torch, fn, "block_cosine_prior")
                    extra = (f", bucket {ut}, {entry['channels_per_pass']} channels a pass, "
                             f"max|d| vs kernel B {entry['max_abs_err_vs_kernel_b']:.3e}")
                log(f"kernel {key} {'block_' if key == 'D' else ''}cosine_prior bf16 scale {s} "
                    f"table {list(table.shape)} G={G} R={R} S={S}: max|d| {err:.3e} (tol "
                    f"1e-4), {entry['ms']:.4f} ms vs plain {entry['plain_ms']:.3f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by}){extra}")
                check_close(f"{key} bf16 scale {s} R={R}", err, 1e-4)
                if key == "D":
                    check_close(f"D vs B bf16 scale {s} R={R}",
                                entry["max_abs_err_vs_kernel_b"], 1e-4)
                res[f"{key}_bf16"].append(entry)
                del got
            del out_b
    del tables
    torch.cuda.empty_cache()


def make_video_sample(seed, img_w, img_h):
    """The synthetic scene as a COLMAP-style sample: 3 source cameras and a
    target, near/far by the demo's nf_mode minmax."""
    from matchnerf_tpu_torch.data import synth
    from matchnerf_tpu_torch.data.common import make_near_fars
    rng = np.random.default_rng(seed + 5)
    eyes = [np.asarray(e) + rng.uniform(-0.02, 0.02, 3) for e in synth.DEFAULT_EYES]
    views = synth.make_scene_views(img_w, img_h, eyes=eyes)
    return {"images": views["images"], "extrinsics": views["w2cs"],
            "intrinsics": views["intrinsics"],
            "near_fars": make_near_fars(list(views["near_fars"]), 4, "minmax"),
            "view_ids": np.arange(4), "scene": "synth",
            "img_wh": np.array([img_w, img_h]), "c2ws_all": views["c2ws"][:3]}


def plain_frame0(cfg, model, dev, batch, n_slices=None, mode="interpolate", setbg=False):
    """Frame 0 of the batch's `mode` path (interpolate, or the LLFF spiral),
    every kernel replaced by its plain version, onto a white background
    with setbg: dict of [1, H*W, *], or of the first n_slices ray slices
    only."""
    import torch
    from matchnerf_tpu_torch import camera
    from matchnerf_tpu_torch.models.matchnerf import render_rays
    from matchnerf_tpu_torch.renderer import Renderer, extract_poses
    plain = Renderer(cfg, model, dev, kernel=False)
    plain.setbg_opaque = setbg
    poses = extract_poses(batch)
    n_frames = int(cfg.nerf.video_n_frames)
    frame0 = plain.get_video_rendering_path(poses, mode, n_frames, batch)[0]
    ref_images = plain.tensor(batch["images"][:, :3])
    tables = plain.build_tables(ref_images, plain.encode(ref_images))
    vw, vh = (int(x) for x in batch["img_wh"][0])
    pose = {"tgt": frame0, "ref": poses["ref"]}
    if n_slices is None:
        return plain.render_by_slices(pose, tables, vh, vw)
    R = plain.rays_per_slice(1)
    grid = camera.pixel_grid(vh, vw, legacy=cfg.nerf.legacy_coord, device=plain.device)
    outs = []
    with torch.no_grad():
        for s0 in range(0, n_slices * R, R):
            outs.append(render_rays(plain.model, cfg, grid[s0:s0 + R][None],
                                    *plain._pose_tensors(pose), tables, vh, vw,
                                    kernel=False, setbg_opaque=setbg)["rgb"])
    return {"rgb": torch.cat(outs, dim=1)}


def video_phase(torch, dev, seed, counters, profile, name, n_frames, plain_slices=None):
    """Phases 7 and 8: `Coach.test_model_video` of configs/<name>.yaml on the
    synthetic scene (demo_own with the fused cosine); launches counted
    around it; frame 0 (its first plain_slices ray slices, if given) against
    the all-plain render."""
    from matchnerf_tpu_torch.config import CONFIGS
    from matchnerf_tpu_torch.data.loader import DataLoader, collate
    from matchnerf_tpu_torch.engine import Coach
    cfg = CONFIGS[name]()
    fused = name == "demo_own"
    cfg.precision.fused_cosine = fused
    cfg.load = None
    cfg.nerf.video_n_frames = n_frames
    cfg.output_root = os.path.join(REPO, "build", "chip_smoke")
    vw, vh = cfg.data_test.colmap.img_wh
    sample = make_video_sample(seed, vw, vh)

    class SceneSet:
        def __len__(self):
            return 1

        def __getitem__(self, i):
            return sample

        def get_name(self):
            return "colmap"

    coach = Coach(cfg, device=dev)
    coach.test_loaders = [DataLoader(SceneSet())]
    coach.build_networks()
    coach.restore_checkpoint_if_needed()
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    videos = coach.test_model_video()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    plain_cuda = {k: c.plain_on_cuda for k, c in counters.items()}
    routes = coach.renderer.frame_routes
    n_slices = math.ceil(vw * vh / coach.renderer.rays_per_slice(1))
    n_color = sum(r["color_ut"] is not None for r in routes)
    frames_s = n_frames / wall
    S = cfg.nerf.sample_intvs
    log(f"video path ({name}.yaml{', fused_cosine' if fused else ''}) Coach.test_model_video "
        f"{vw}x{vh} S={S}, {n_frames} frames, {n_slices} slices of "
        f"{coach.renderer.rays_per_slice(1)} rays per frame: {wall:.4f} s, {frames_s:.3f} "
        f"frames/s, {frames_s * vw * vh:.0f} rays/s (encode, tables, every frame's pose_prep "
        f"and render, writing); colour union in its bucket on {n_color} of {n_frames} frames; "
        f"routes of frames 0 and {n_frames - 1}: {routes[0]}, {routes[-1]}")
    log(f"video path {name}: launches {launches}, plain versions on CUDA {plain_cuda}")
    frames = n_slices * n_frames
    if fused:
        want = dict({k: 0 for k in counters}, window_attention=12, cond_nerf_decode=frames,
                    fused_cosine=2 * frames, supercell_color=n_slices * n_color)
    else:
        # ray slices that are not 8-aligned: Kernel B and the colour gather
        want = dict({k: 0 for k in counters}, window_attention=12, cond_nerf_decode=frames,
                    cosine_prior=2 * frames)
    if launches != want:
        raise AssertionError(f"video path {name} launches {launches}, expected {want}")
    if any(plain_cuda.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors: {plain_cuda}")
    video = videos[0]
    if video.shape != (n_frames, vh, vw, 3) or not np.isfinite(video).all():
        raise AssertionError(f"video frames {video.shape}, finite {np.isfinite(video).all()}")
    if not (video.min() >= -1e-6 and video.max() <= 1.0 + 1e-6):
        raise AssertionError(f"video rgb outside [0,1]: {video.min()} {video.max()}")
    ref = plain_frame0(cfg, coach.model, dev, collate([sample]), plain_slices)["rgb"].cpu()
    agreement = psnr(torch.as_tensor(video[0]).reshape(1, -1, 3)[:, :ref.shape[1]], ref)
    what = "frame 0" if plain_slices is None else f"frame 0's first {ref.shape[1]} rays"
    log(f"video path {name}: {what}, kernels vs all-plain PSNR {agreement:.2f} dB (need >= 50), "
        f"rgb mean {float(video.mean()):.4f}; outputs in {coach.output_path}")
    if not agreement >= 50.0:
        raise AssertionError(f"video {name} {what} agreement PSNR {agreement:.2f} dB < 50")
    out = {"seconds": wall, "frames_per_s": frames_s, "rays_per_s": frames_s * vw * vh,
           "frames": n_frames, "img_wh": [vw, vh], "samples_per_ray": S,
           "slices_per_frame": n_slices, "color_ut_frames": n_color,
           "frame0_psnr_vs_plain_db": agreement, "frame0_rays_compared": int(ref.shape[1]),
           "launches": launches}
    if profile:
        out["profile"] = profile_call(torch, f"video {name}", coach.test_model_video)
    return out


def timed_hook(torch, fn, times):
    """`fn` with its synchronised wall seconds appended to `times`."""
    def run(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn(*a, **k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return r
    return run


def loop_args(label, name, runs, root, meta, max_len, **over):
    """The training CLI's arguments for one run on the synthetic DTU tree
    (the DTU test split only: the port has no LLFF or Blender loader)."""
    args = {"name": name, "output_root": runs, "max_epoch": 1, "tb": "false",
            "encoder.pretrain_weight": "", "freq.scalar": 1, "freq.val_it": 0.5,
            "freq.ckpt_it": 0.5, "data_train.max_len": max_len, "data_val.max_len": 1,
            "data_test.dtu.max_len": 1, "data_test.llff": "", "data_test.blender": ""}
    for block in ("data_train", "data_val", "data_test.dtu"):
        args[f"{block}.root_dir"] = root
        args[f"{block}.meta_dir"] = meta
    args.update(over)
    return ["--config", label] + [f"--{k}={v}" for k, v in args.items()]


def loop_phase(torch, dev, counters):
    """Phase 12: the training loop of configs/train.yaml and train_fast.yaml
    (`python -m matchnerf_tpu_torch.train`'s `build_coach` and `train_model`)
    on a synthetic 640x512 DTU tree: 4 steps, validation every 2 (4096-ray
    slices on bf16 tables through Kernels A, C, D and E), a mid-epoch
    checkpoint every 2, the DTU test view and the epoch checkpoint; then
    SIGTERM to a run in a subprocess after its first checkpoint, and the
    resume."""
    import tempfile

    from matchnerf_tpu_torch.data import png, synth
    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.renderer import Renderer
    from matchnerf_tpu_torch.train import build_coach
    from matchnerf_tpu_torch.utils.checkpoint import load_checkpoint
    work = tempfile.mkdtemp(prefix="chip_smoke_dtu_", dir=os.path.join(REPO, "build"))
    root, meta, runs = (os.path.join(work, d) for d in ("DTU", "meta", "runs"))
    t0 = time.perf_counter()
    synth.write_dtu_scene(root, meta)
    rect = os.path.join(root, "Rectified", "scan1_train")
    filters = np.bincount(np.concatenate([
        png._read_filtered(os.path.join(rect, f))[1] for f in sorted(os.listdir(rect))]),
        minlength=5)
    log(f"loop phase: synthetic DTU tree {H}x{W}, views {list(synth.DTU_SCENE_VIEW_IDS)} "
        f"(val/test 24) in {time.perf_counter() - t0:.1f} s under {work}; PNG rows by filter "
        f"(None, Sub, Up, Average, Paeth) {filters.tolist()}")
    if np.count_nonzero(filters[[1, 3, 4]]) == 0:
        raise AssertionError(f"the tree's PNGs use no filter with a left neighbour: {filters}")
    out = {}
    for label in ("train", "train_fast"):
        coach = build_coach(loop_args(label, f"loop_{label}", runs, root, meta, LOOP_STEPS))
        timed = {"validate_s": [], "test_s": []}
        coach.validate_model = timed_hook(torch, coach.validate_model, timed["validate_s"])
        coach.test_model = timed_hook(torch, coach.test_model, timed["test_s"])
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        coach.train_model()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches = {k: c.launches for k, c in counters.items()}
        plain_cuda = {k: c.plain_on_cuda for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        with open(coach.scalars_path) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["loss_render"] for r in recs if r["split"] == "train"]
        vals = [r for r in recs if r["split"] == "val"]
        mdir = os.path.join(coach.output_path, "models")
        ckpts = sorted(os.listdir(mdir))
        hooks_s = sum(timed["validate_s"]) + sum(timed["test_s"])
        steps_per_s = LOOP_STEPS / (wall - hooks_s)
        # the loader alone: seconds to read one training sample (4 PNGs
        # decoded, cameras) on this thread, the most steps/s it can feed
        data = coach.train_loader.dataset
        t0 = time.perf_counter()
        for i in range(LOOP_STEPS):
            data[i]
        sample_s = (time.perf_counter() - t0) / LOOP_STEPS
        log(f"loop {label}.yaml: {LOOP_STEPS} steps in {wall:.3f} s with {len(vals)} "
            f"validations ({[round(t, 3) for t in timed['validate_s']]} s) and "
            f"{len(timed['test_s'])} test ({[round(t, 3) for t in timed['test_s']]} s): "
            f"{steps_per_s:.3f} steps/s outside them; the loader alone {sample_s:.4f} s a "
            f"sample ({1 / sample_s:.3f} samples/s); losses {[round(x, 6) for x in losses]}; "
            f"checkpoints {ckpts}; peak device memory {peak:.2f} GiB; {card_line()}")
        log(f"loop {label}.yaml: launches {run_launches}, plain versions on CUDA {plain_cuda}, "
            f"B by route {kb.COUNTER.by_entry}, D by route {kd.COUNTER.by_entry}")
        if len(losses) != LOOP_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"loop {label}: losses {losses}")
        if ckpts != ["ep1_it%d.ckpt" % LOOP_STEPS, "latest.ckpt"]:
            raise AssertionError(f"loop {label}: checkpoints {ckpts}")
        if len(vals) != 2 or not all(math.isfinite(r["PSNR"]) and math.isfinite(r["SSIM"])
                                     for r in vals):
            raise AssertionError(f"loop {label}: validation scalars {vals}")
        if any(plain_cuda.values()):
            raise AssertionError(f"loop {label}: plain versions ran on CUDA: {plain_cuda}")
        # the steps' table gradient: B' on train.yaml's iid rays, D' on
        # train_fast.yaml's strips (the tree's training poses fit its staging)
        bwd = "cosine_prior_bwd" if label == "train" else "block_cosine_prior_bwd"
        if run_launches[bwd] != 2 * LOOP_STEPS:
            raise AssertionError(f"loop {label}: {bwd} launched {run_launches[bwd]} times")

        # one validation image alone: its launches, seconds, and its render
        # (kept) against the all-plain one
        renders = []
        forward = coach.renderer.forward
        coach.renderer.forward = lambda *a, **k: renders.append(forward(*a, **k)) or renders[-1]
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coach.validate_model(iteration=coach.it)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
        coach.renderer.forward = forward
        val_launches = {k: c.launches for k, c in counters.items()}
        routes = {"B": dict(kb.COUNTER.by_entry), "D": dict(kd.COUNTER.by_entry)}
        route = coach.renderer.last_route
        log(f"loop {label}.yaml: training route {coach.last_route} (None: B'); one validation "
            f"image {val_s:.4f} s, route {route}, launches "
            f"{val_launches}, B {routes['B']}, D {routes['D']}")
        n_block = sum(u is not None for u in route["block_ut"] or ())
        if n_block and routes["D"].get("block_cosine_prior_bf16", 0) <= 0:
            raise AssertionError(f"loop {label}: Kernel D's bf16 form did not launch")
        if n_block < 2 and routes["B"].get("cosine_prior_bf16", 0) <= 0:
            raise AssertionError(f"loop {label}: Kernel B's bf16 form did not launch")
        if set(routes["B"]) - {"cosine_prior_bf16"} or set(routes["D"]) - {
                "block_cosine_prior_bf16"}:
            raise AssertionError(f"loop {label}: tables other than bf16 in validation {routes}")
        entry = {"steps": LOOP_STEPS, "wall_s": wall, "steps_per_s": steps_per_s,
                 "loader_sample_s": sample_s, "png_rows_by_filter": filters.tolist(),
                 "validate_s": timed["validate_s"][:-1], "test_s": timed["test_s"],
                 "validation_image_s": val_s, "peak_gib": peak, "losses": losses,
                 "checkpoints": ckpts, "launches": run_launches,
                 "validation_launches": val_launches, "validation_routes": routes,
                 "route": route, "val_psnr": [r["PSNR"] for r in vals],
                 "val_ssim": [r["SSIM"] for r in vals]}
        if label == "train":
            batch = next(iter(coach.val_loader))
            kern = renders[0]["rgb"]
            plain = Renderer(coach.cfg, coach.model, dev, kernel=False).forward(
                batch, mode="val")["rgb"]
            entry["psnr_vs_plain_db"] = psnr(kern, plain)
            # the same view with every scale through Kernel B (block_kernel off)
            ray_cfg = copy.deepcopy(coach.cfg)
            ray_cfg.precision.block_kernel = False
            before = kb.COUNTER.by_entry.get("cosine_prior_bf16", 0)
            ray = Renderer(ray_cfg, coach.model, dev).forward(batch, mode="val")["rgb"]
            entry["per_ray_b_bf16_launches"] = kb.COUNTER.by_entry["cosine_prior_bf16"] - before
            entry["per_ray_psnr_vs_block_db"] = psnr(ray, kern)
            log(f"loop {label}.yaml: validation image kernels vs all-plain PSNR "
                f"{entry['psnr_vs_plain_db']:.2f} dB (need >= 50); through Kernel B's bf16 "
                f"form ({entry['per_ray_b_bf16_launches']} launches) vs the block route "
                f"{entry['per_ray_psnr_vs_block_db']:.2f} dB (need >= 60)")
            if not entry["psnr_vs_plain_db"] >= 50.0:
                raise AssertionError(f"loop validation PSNR {entry['psnr_vs_plain_db']} < 50")
            if not (entry["per_ray_b_bf16_launches"] > 0
                    and entry["per_ray_psnr_vs_block_db"] >= 60.0):
                raise AssertionError(f"loop validation through Kernel B: {entry}")
            del kern, plain, ray
        out[label] = entry
        del coach
        torch.cuda.empty_cache()

    # preemption: SIGTERM to a training run once its first mid-epoch
    # checkpoint is on disk, then the resume
    args = loop_args("train", "loop_preempt", runs, root, meta, PREEMPT_STEPS,
                     **{"freq.ckpt_it": 2 / PREEMPT_STEPS, "freq.val_it": -1,
                        "freq.test_ep": -1, "freq.scalar": 0})
    latest = os.path.join(runs, "loop_preempt", "models", "latest.ckpt")
    log_path = os.path.join(work, "preempt.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen([sys.executable, "-m", "matchnerf_tpu_torch.train", *args],
                                cwd=REPO, stdout=log_file, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None and not os.path.exists(latest):
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("preemption run wrote no checkpoint in 300 s")
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ckpt = load_checkpoint(latest)
    with open(log_path) as f:
        tail = f.read()[-2000:]
    log(f"loop preemption: SIGTERM after the first checkpoint, exit code {code} after "
        f"{time.perf_counter() - t0:.1f} s, latest.ckpt at epoch {ckpt['epoch']} iteration "
        f"{ckpt['iter']} of {PREEMPT_STEPS}")
    if code != 128 + signal.SIGTERM or not 0 < ckpt["iter"] < PREEMPT_STEPS:
        raise AssertionError(f"preemption: exit {code}, iteration {ckpt['iter']}; log:\n{tail}")
    coach = build_coach(args + ["--resume"])
    if (coach.epoch_start, coach.iter_start) != (ckpt["epoch"], ckpt["iter"]):
        raise AssertionError(f"resume at {coach.epoch_start}, {coach.iter_start}")
    model_equal = all(torch.equal(v.cpu(), ckpt["model"][k])
                      for k, v in coach.model.state_dict().items())
    opt = coach.opt.state_dict()
    adam, adam_ckpt = opt["adamw"]["state"], ckpt["optim"]["adamw"]["state"]
    opt_equal = (opt["count"] == ckpt["optim"]["count"] and adam.keys() == adam_ckpt.keys()
                 and all(torch.equal(adam[i][k].cpu(), adam_ckpt[i][k])
                         for i in adam for k in adam[i]))
    steps = []
    step = coach.step
    coach.step = lambda *a, **k: steps.append(1) or step(*a, **k)
    coach.train_model()
    log(f"loop resume: from iteration {coach.iter_start}, model bit-equal {model_equal}, "
        f"AdamW and schedule state bit-equal {opt_equal}, {len(steps)} steps taken (the "
        f"{coach.iter_start} loaded batches skipped), ending at iteration {coach.it}")
    if not (model_equal and opt_equal and len(steps) == PREEMPT_STEPS - ckpt["iter"]
            and coach.it == PREEMPT_STEPS):
        raise AssertionError("resume did not continue from the checkpoint")
    out["preempt"] = {"exit_code": code, "iter": ckpt["iter"], "steps": PREEMPT_STEPS,
                      "resumed_steps": len(steps), "model_bit_equal": model_equal,
                      "optimizer_bit_equal": opt_equal}
    del coach
    torch.cuda.empty_cache()
    return out


EVAL_SETS = {"dtu": (640, 512), "llff": (960, 640), "blender": (800, 800)}
ENTRY_FRAMES = 3                   # frames of the test_video runs of phase 13
# the device kernels of the eval path, by the start of their __global__'s name
KERNEL_NAMES = {"window_attention": "window_attention_fwd", "cosine_prior": "cosine_prior_kernel",
                "cond_nerf_decode": "cond_nerf_decode_kernel",
                "block_cosine_prior": "block_cosine_prior_kernel",
                "supercell_color": "supercell_color_kernel"}
KERNEL_RES = {k: re.compile(r"\b" + v) for k, v in KERNEL_NAMES.items()}


def kernel_device_ms(torch, fn):
    """One warm call of `fn` under torch.profiler -> {kernel: (device ms,
    launches)} for the eval kernels of KERNEL_NAMES."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name, pattern in KERNEL_RES.items():
            if e.device_time_total > 0 and pattern.search(e.key):
                ms, n = out.get(name, (0.0, 0))
                out[name] = (ms + e.device_time_total / 1e3, n + e.count)
    return out


def write_eval_trees(work):
    """Synthetic DTU (640x512), LLFF (960x640) and Blender (800x800) test
    trees, one target view each, with their own meta dirs -> the entry's
    --data_test.<set>.root_dir / meta_dir arguments per set."""
    from matchnerf_tpu_torch.data import synth
    writers = {"dtu": synth.write_dtu_scene, "llff": synth.write_llff_tree,
               "blender": synth.write_blender_tree}
    args = {}
    for name, (w, h) in EVAL_SETS.items():
        root, meta = os.path.join(work, name), os.path.join(work, f"{name}_meta")
        writers[name](root, meta, w, h)
        args[name] = [f"--data_test.{name}.root_dir={root}",
                      f"--data_test.{name}.meta_dir={meta}", f"--data_test.{name}.max_len=1"]
    return args


def run_entry(torch, counters, argv):
    """`matchnerf_tpu_torch.test.main(argv)` in this process, with every
    `Renderer.forward` it makes (one per test set) recorded: the counts set
    to 0 just before it and read just after, its timings, route, background
    and output -> (main's result, the records)."""
    from matchnerf_tpu_torch import test as entry
    from matchnerf_tpu_torch.ops import decoder as kc
    from matchnerf_tpu_torch.renderer import Renderer
    records = []
    forward = Renderer.forward

    def recorded(self, batch, *a, **k):
        for c in counters.values():
            c.reset()
        t = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward(self, batch, *a, timings=t, **k)
        torch.cuda.synchronize()
        records.append({
            "renderer": self, "batch": batch, "out": out, "kwargs": k,
            "seconds": time.perf_counter() - t0, "timings": t,
            "launches": {n: c.launches for n, c in counters.items()},
            "plain_cuda": {n: c.plain_on_cuda for n, c in counters.items()},
            "routes": {n: dict(c.by_entry) for n, c in counters.items() if c.by_entry},
            "setbg_launches": kc.COUNTER.by_variant.get("setbg", 0),
            "setbg": self.setbg_opaque, "route": self.last_route,
            "frame_routes": list(self.frame_routes)})
        return out
    Renderer.forward = recorded
    try:
        result = entry.main(argv)
    finally:
        Renderer.forward = forward
    return result, records


def check_entry_record(name, rec, must, label):
    """The checks every set's render passes: the kernels of `must` launched,
    none of the plain versions on CUDA, Kernel C with setbg on Blender (every
    launch) and nowhere else, rgb finite in [0, 1]."""
    launches, out = rec["launches"], rec["out"]
    for k in must:
        if launches[k] <= 0:
            raise AssertionError(f"{label} {name}: kernel {k} was not launched: {launches}")
    if any(rec["plain_cuda"].values()):
        raise AssertionError(f"{label} {name}: plain versions ran on CUDA: {rec['plain_cuda']}")
    want_bg = launches["cond_nerf_decode"] if name == "blender" else 0
    if rec["setbg"] != (name == "blender") or rec["setbg_launches"] != want_bg:
        raise AssertionError(f"{label} {name}: setbg {rec['setbg']}, {rec['setbg_launches']} "
                             f"Kernel C launches with setbg of {launches['cond_nerf_decode']}")
    for k, v in out.items():
        if not bool(v.isfinite().all()):
            raise AssertionError(f"{label} {name}: non-finite {k}")
    rgb = out["rgb"]
    if not (float(rgb.min()) >= -1e-6 and float(rgb.max()) <= 1.0 + 1e-6):
        raise AssertionError(f"{label} {name}: rgb outside [0,1]: {float(rgb.min())} "
                             f"{float(rgb.max())}")


def eval_entry_phase(torch, dev, seed):
    """Phase 13: `python -m matchnerf_tpu_torch.test --config test` (its
    `main`, in this process, on the card) over synthetic DTU, LLFF and
    Blender test trees at configs/test.yaml's sizes, full width, seeded
    weights; then `--config test_video` (3 frames) on the LLFF and Blender
    trees and `--config test_strict` on the DTU tree."""
    import tempfile

    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.ops import decoder as kc
    from matchnerf_tpu_torch.ops import fused_cosine as kf
    from matchnerf_tpu_torch.ops import supercell_color as ke
    from matchnerf_tpu_torch.ops import window_attention as ka
    from matchnerf_tpu_torch.renderer import Renderer
    counters = {"window_attention": ka.COUNTER, "cosine_prior": kb.COUNTER,
                "cond_nerf_decode": kc.COUNTER, "block_cosine_prior": kd.COUNTER,
                "supercell_color": ke.COUNTER, "fused_cosine": kf.COUNTER}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_eval_", dir=os.path.join(REPO, "build"))
    t0 = time.perf_counter()
    trees = write_eval_trees(work)
    log(f"eval entry: synthetic test trees {EVAL_SETS} (one target view each) in "
        f"{time.perf_counter() - t0:.1f} s under {work}")
    runs = os.path.join(work, "runs")
    common = ["--load=", f"--output_root={runs}", f"--seed={seed}", "--data_test.tnt="]
    card = card_line()
    out = {"sets": {}, "card": card}

    # configs/test.yaml: DTU, LLFF and Blender
    argv = ["--config", "test", "--name=test", *common] + sum(trees.values(), [])
    t0 = time.perf_counter()
    sums, records = run_entry(torch, counters, argv)
    wall = time.perf_counter() - t0
    if len(records) != len(EVAL_SETS):
        raise AssertionError(f"eval entry: {len(records)} renders for {list(EVAL_SETS)}")
    test_dir = os.path.join(runs, "test", "test")
    for name, rec in zip(EVAL_SETS, records):
        w, h = EVAL_SETS[name]
        check_entry_record(name, rec, ["window_attention", "cond_nerf_decode",
                                       "block_cosine_prior", "supercell_color"], "eval entry")
        renderer, route = rec["renderer"], rec["route"]
        overflow = [i for i, u in enumerate(route["block_ut"] or ()) if u is None]
        if rec["launches"]["cosine_prior"]:
            log(f"eval entry {name}: Kernel B took scale(s) {overflow} of the target pose "
                f"(view {int(rec['batch']['view_ids'][0][-1])}): its block union overflowed "
                f"the buckets, route {route}")
        plain = Renderer(renderer.cfg, renderer.model, dev, kernel=False)
        plain.setbg_opaque = rec["setbg"]
        plain_t = {}
        ref = plain.forward(rec["batch"], mode="test", timings=plain_t)
        agreement = psnr(rec["out"]["rgb"], ref["rgb"])
        del ref
        files = sorted(os.listdir(os.path.join(test_dir, name)))
        if not (files and os.path.isfile(os.path.join(test_dir, f"0results_{name}.txt"))):
            raise AssertionError(f"eval entry {name}: outputs {files} in {test_dir}")
        kms = kernel_device_ms(torch, lambda: renderer.forward(rec["batch"], mode="test"))
        t = rec["timings"]
        n_rays = w * h
        # Kernel A's windows: 6 streams x 2x2 windows of the 1/8-scale map,
        # bf16 operands; its bound as in phase 3 (4 BW L^2 C operations)
        L = (h // 16) * (w // 16)
        a_bound, a_by = bound(4 * 24 * L * 128 * 2, 4 * 24 * L * L * 128, "bfloat16",
                              TC_FLOPS)
        entry = {"img_wh": [w, h], "render_s": t["render"], "encode_s": t["encode"],
                 "tables_s": t["tables"], "pose_prep_s": t.get("pose_prep", 0.0),
                 "rays_per_s_render": n_rays / t["render"], "forward_s": rec["seconds"],
                 "plain_render_s": plain_t["render"], "psnr_vs_plain_db": agreement,
                 "route": route, "setbg": rec["setbg"], "setbg_launches": rec["setbg_launches"],
                 "launches": rec["launches"], "launches_by_route": rec["routes"],
                 "kernel_device_ms": {k: {"ms": ms, "launches": n, "ms_per_launch": ms / n}
                                      for k, (ms, n) in kms.items()},
                 "window_attention_shape": {"BW": 24, "L": L, "C": 128, "bound_ms": a_bound,
                                            "bound_by": a_by},
                 "psnr_vs_gt": sums[name]["PSNR"], "outputs": files}
        out["sets"][name] = entry
        log(f"eval entry {name} {w}x{h} S={renderer.cfg.nerf.sample_intvs}: render "
            f"{t['render']:.4f} s (pose_prep {entry['pose_prep_s']:.4f}), encode "
            f"{t['encode']:.4f}, tables {t['tables']:.4f}, {entry['rays_per_s_render']:.0f} "
            f"rays/s (render); route per scale {route['block_ut']} (None: Kernel B), colour "
            f"{route['color_ut']}; setbg {rec['setbg']} ({rec['setbg_launches']} C launches); "
            f"launches {rec['launches']}; kernels vs all-plain PSNR {agreement:.2f} dB "
            f"(need >= 50; plain render {plain_t['render']:.3f} s); device ms (launches) "
            + ", ".join(f"{k} {ms:.3f} ({n})" for k, (ms, n) in sorted(kms.items()))
            + f"; Kernel A at [24,{L},128] bf16, bound {a_bound:.4f} ms ({a_by}); {card}")
        if not agreement >= 50.0:
            raise AssertionError(f"eval entry {name}: agreement PSNR {agreement:.2f} dB < 50")
    out["wall_s"] = wall
    dtu_rgb = records[0]["out"]["rgb"]
    del records
    torch.cuda.empty_cache()

    # configs/test_video.yaml: the LLFF spiral and Blender's interpolated path
    argv = (["--config", "test_video", "--name=test_video", *common, "--data_test.dtu=",
             f"--nerf.video_n_frames={ENTRY_FRAMES}"] + trees["llff"] + trees["blender"])
    videos, records = run_entry(torch, counters, argv)
    out["video"] = {}
    for name, rec, video in zip(("llff", "blender"), records, videos):
        check_entry_record(name, rec, ["window_attention", "cond_nerf_decode"], "eval video")
        mode = rec["kwargs"]["render_path_mode"]
        if mode != ("spiral" if name == "llff" else "interpolate"):
            raise AssertionError(f"eval video {name}: path mode {mode}")
        renderer = rec["renderer"]
        ref = plain_frame0(renderer.cfg, renderer.model, dev, rec["batch"], mode=mode,
                           setbg=rec["setbg"])["rgb"]
        agreement = psnr(rec["out"]["rgb"][:1], ref)
        log(f"eval video {name} ({mode}, {ENTRY_FRAMES} frames): {rec['seconds']:.3f} s, "
            f"frame routes {[r['block_ut'] for r in rec['frame_routes']]}, launches "
            f"{rec['launches']}, setbg {rec['setbg']} ({rec['setbg_launches']} C launches); "
            f"frame 0 vs all-plain PSNR {agreement:.2f} dB (need >= 50); {card}")
        if video.shape[0] != ENTRY_FRAMES or not agreement >= 50.0:
            raise AssertionError(f"eval video {name}: {video.shape[0]} frames, frame 0 "
                                 f"agreement {agreement:.2f} dB")
        out["video"][name] = {"mode": mode, "seconds": rec["seconds"],
                              "psnr_vs_plain_db": agreement, "launches": rec["launches"],
                              "setbg_launches": rec["setbg_launches"]}
    del records
    torch.cuda.empty_cache()

    # configs/test_strict.yaml on the DTU tree: Kernel A's f32 route, the cond
    # query and the decoder in torch ops (precision.strict)
    argv = (["--config", "test_strict", "--name=test_strict", *common, "--data_test.llff=",
             "--data_test.blender="] + trees["dtu"])
    _, records = run_entry(torch, counters, argv)
    rec = records[0]
    rgb = rec["out"]["rgb"]
    finite = all(bool(v.isfinite().all()) for v in rec["out"].values())
    vs_shipped = psnr(rgb, dtu_rgb)
    log(f"eval strict dtu (configs/test_strict.yaml): render {rec['timings']['render']:.4f} s, "
        f"encode {rec['timings']['encode']:.4f} s; Kernel A by route {rec['routes']}, launches "
        f"{rec['launches']}, plain versions on CUDA (the strict cond query) "
        f"{rec['plain_cuda']}; finite {finite}; vs the shipped-config render PSNR "
        f"{vs_shipped:.2f} dB; {card}")
    if rec["routes"].get("window_attention") != {"window_attention_f32": 12} or not finite:
        raise AssertionError(f"eval strict: Kernel A routes {rec['routes']}, finite {finite}")
    out["strict"] = {"render_s": rec["timings"]["render"], "encode_s": rec["timings"]["encode"],
                     "launches": rec["launches"], "routes": rec["routes"],
                     "psnr_vs_shipped_db": vs_shipped}
    del records, dtu_rgb
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm render of each path")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this test runs on an NVIDIA GPU only")
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from matchnerf_tpu_torch import camera, kernels
    from matchnerf_tpu_torch.config import (dtu_eval_config, dtu_eval_per_ray_config,
                                            test_video_own_config)
    from matchnerf_tpu_torch.models.matchnerf import (init_matchnerf,
                                                      project_to_views,
                                                      query_cond_info,
                                                      sample_depth)
    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.ops import decoder as kc
    from matchnerf_tpu_torch.ops import fused_cosine as kf
    from matchnerf_tpu_torch.ops import supercell_color as ke
    from matchnerf_tpu_torch.ops import window_attention as ka
    from matchnerf_tpu_torch.ops.attention import shift_region_ids
    from matchnerf_tpu_torch.renderer import Renderer, extract_poses

    # ---- 1. device
    dev = torch.device(DEVICE)
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for matmuls and cuDNN (torch.backends.cuda.matmul.allow_tf32 "
        "= torch.backends.cudnn.allow_tf32 = False)")
    t0 = time.perf_counter()
    kernels.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(kernels.NVCC_FLAGS)})")

    # ---- 2. scene and model
    cfg = dtu_eval_config()
    per_ray_cfg = dtu_eval_per_ray_config()
    t0 = time.perf_counter()
    batch = make_scene(args.seed)
    log(f"scene: {H}x{W}, 3 source views + target, near/far {DTU_NEAR_FAR}, "
        f"{time.perf_counter() - t0:.1f} s")
    model = init_matchnerf(cfg, torch.Generator().manual_seed(args.seed)).to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {n_params} parameters, "
        f"{cfg.encoder.num_transformer_layers} transformer layers, "
        f"precision {dict(cfg.precision)}")
    renderer = Renderer(cfg, model, dev)
    plain_renderer = Renderer(cfg, model, dev, kernel=False)
    per_ray_renderer = Renderer(per_ray_cfg, model, dev)

    # ---- 3. kernel phases at the main path's shapes
    res = {}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.no_grad():
        # A: 2 * B * P = 6 streams of the 64x80 1/8-scale map, 2x2 windows
        rid = shift_region_ids(64, 80, 2, device=dev)
        for dt, tol, lse_tol in ((torch.bfloat16, 3e-2, 2e-2), (torch.float32, 1e-4, 1e-3)):
            q, k, v = (torch.randn(24, 1280, 128, generator=gen, device=dev).to(dt)
                       for _ in range(3))
            got = ka.window_attention(q, k, v, rid)
            ref = ka.window_attention_plain(q, k, v, rid)
            # the training forward's logsumexp against the plain masked scores
            lse = ka.window_attention_forward(q, k, v, rid, with_lse=True)[1]
            lse_err = max_abs(lse, torch.logsumexp(ka.attention_scores_plain(q, k, rid), -1))
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            tol_abs = tol * max(1.0, float(ref.float().abs().max()))
            ms = cuda_ms(torch, lambda: ka.window_attention(q, k, v, rid), 50)
            lse_ms = cuda_ms(torch, lambda: ka.window_attention_forward(q, k, v, rid, True), 50)
            plain_ms = cuda_ms(torch, lambda: ka.window_attention_plain(q, k, v, rid), 5)
            # library yardstick: SDPA with the -100 region mask as a float mask
            rows = rid[torch.arange(24, device=dev) % rid.shape[0]]
            mask = torch.where(rows[:, :, None] != rows[:, None, :], -100.0, 0.0)
            mask = mask[:, None].to(dt)
            lib = lambda: F.scaled_dot_product_attention(q[:, None], k[:, None],
                                                         v[:, None], attn_mask=mask)
            lib_err = float((lib()[:, 0].float() - ref.float()).abs().max())
            lib_ms = cuda_ms(torch, lib, 50)
            lib_kernels = kernel_names(torch, lib)
            del mask
            name = str(dt).replace("torch.", "")
            flops = 4 * 24 * 1280 * 1280 * 128
            b_ms, b_by = bound(nbytes(q, k, v, got, rid), flops, name, TC_FLOPS)
            log(f"kernel A window_attention {name} [24,1280,128] shift-masked: "
                f"max|d| {err:.3e} (tol {tol_abs:.3e}), {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                f"TFLOP/s); with the logsumexp {lse_ms:.4f} ms, lse max|d| {lse_err:.3e} (tol "
                f"{lse_tol:g}); plain {plain_ms:.3f} ms, library SDPA {lib_ms:.4f} ms (max|d| "
                f"{lib_err:.3e}), bound {b_ms:.4f} ms ({b_by}, at {TC_FLOPS[name] / 1e12:.0f} "
                f"TFLOP/s); SDPA's kernels {lib_kernels}")
            check_close(f"window_attention {name}", err, tol_abs)
            check_close(f"window_attention {name} logsumexp", lse_err, lse_tol)
            res[f"A_{name}"] = dict(max_abs_err=err, ms=ms, lse_ms=lse_ms, lse_max_abs_err=lse_err,
                                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                    library_ms=lib_ms, library_max_abs_err=lib_err,
                                    library_kernels=lib_kernels)
            del q, k, v, got, ref, lse

        # B, D, E and C on the first 20480 rays of the target view, real tables
        ref_images = renderer.tensor(batch["images"][:, :3])
        feats = renderer.encode(ref_images)
        tables = renderer.build_tables(ref_images, feats)
        poses = extract_poses(batch)
        scale_hws = [(t.shape[2], t.shape[3]) for t in tables["view_feats"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block_ut, color_ut = renderer.pose_prep(poses, scale_hws, H, W, measure_color=True)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        log(f"pose_prep: block_ut {block_ut}, color_ut {color_ut} "
            f"(whole image, {prep_s:.4f} s)")
        if block_ut is None or None in block_ut or color_ut is None:
            raise AssertionError("the scene's pose does not take the block route at "
                                 f"both scales and for colour: {block_ut}, {color_ut}")
        R = SLICE_RAYS
        pix = camera.pixel_grid(H, W, legacy=True, device=dev)[:R][None]
        tgt_intr = renderer.tensor(poses["tgt"]["intrinsics"])
        c2w = renderer.tensor(renderer.prepare_target(poses["tgt"]["extrinsics"]))
        tgt_nf = renderer.tensor(poses["tgt"]["near_fars"])
        ref_w2c = renderer.tensor(poses["ref"]["extrinsics"][..., :3, :])
        ref_intr = renderer.tensor(poses["ref"]["intrinsics"])
        ref_nf = renderer.tensor(poses["ref"]["near_fars"])
        center, ray = camera.get_center_and_ray(pix, tgt_intr, c2w)
        depth = sample_depth(cfg, tgt_nf, 1, R)
        pts = camera.get_3d_points_from_depth(center, ray, depth, multi_samples=True)
        grids = (project_to_views(pts, ref_w2c, ref_intr, ref_nf, H, W)[..., :2]
                 * 2.0 - 1.0)[:, 0].contiguous()                     # [V,R,S,2]
        S = grids.shape[2]
        N = R * S
        for key in ("B", "D"):
            res[key] = []
        for s, G in enumerate(cfg.encoder.cos_n_group):
            table = tables["view_feats"][s][0]
            scales = tables["view_feat_scales"][s][0]
            out_b = kb.cosine_prior(table, grids, scales, G)
            flops = prior_flops(N, scaled=True)
            b_ms, b_by = bound(nbytes(table, grids, scales, out_b), flops)
            for key, fn, plain in (
                    ("B", lambda: kb.cosine_prior(table, grids, scales, G),
                     lambda: kb.cosine_prior_plain(table, grids, scales, G)),
                    ("D", lambda: kd.block_cosine_prior(table, grids, scales, G, block_ut[s]),
                     lambda: kd.block_cosine_prior_plain(table, grids, scales, G,
                                                         block_ut[s]))):
                got, ref = fn(), plain()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                ms = cuda_ms(torch, fn, 10)
                plain_ms = cuda_ms(torch, plain, 3)
                entry = dict(scale=s, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by)
                extra = ""
                if key == "D":
                    gp = kd.pad_rays(grids)
                    h, w = scale_hws[s]
                    # the kernel builds its unions itself: only the plain
                    # twin's torch build is timed apart
                    entry["plain_union_ms"] = cuda_ms(
                        torch, lambda: kd.block_unions(gp, h, w, block_ut[s]), 10)
                    entry["union_size"] = kd.block_union_size_raw(gp, h, w)
                    entry["ut"] = block_ut[s]
                    entry["max_abs_err_vs_kernel_b"] = float((got - out_b).abs().max())
                    entry["device_kernels"] = only_kernel(torch, fn, "block_cosine_prior")
                    extra = (f", union {entry['union_size']} rows (bucket {block_ut[s]}), "
                             f"the plain twin's torch union build {entry['plain_union_ms']:.3f} "
                             f"ms, max|d| vs kernel B {entry['max_abs_err_vs_kernel_b']:.3e}, "
                             f"device kernels of the call {entry['device_kernels']}")
                log(f"kernel {key} {'block_' if key == 'D' else ''}cosine_prior scale {s} "
                    f"table {list(table.shape)} int8 G={G} R={R} S={S}: max|d| {err:.3e} "
                    f"(tol 1e-4), {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
                    f"bound {b_ms:.4f} ms ({b_by}){extra}")
                check_close(f"{key} scale {s}", err, 1e-4)
                if key == "D":      # pins the union build, shared by D and its plain twin
                    check_close(f"D vs B scale {s}", entry["max_abs_err_vs_kernel_b"], 1e-4)
                res[key].append(entry)
            del out_b, got, ref

        csc = tables["colors_sc"][0]
        e_fn = lambda: ke.supercell_color_sample(csc, grids, H, W)
        e_plain = lambda: ke.supercell_color_sample_plain(csc, grids, H, W)
        got, ref = e_fn(), e_plain()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        # 9 flops per (sample, view, colour): two y blends and one x blend
        b_ms, b_by = bound(nbytes(csc, grids, got), N * 3 * 3 * 9)
        # library yardstick: F.grid_sample (bilinear, border, align_corners)
        # on the source images as f32 on the 0-255 scale, [V,3,R,S]
        img_f = tables["colors"][0].permute(0, 3, 1, 2).float().contiguous()
        lib = lambda: F.grid_sample(img_f, grids, mode="bilinear", padding_mode="border",
                                    align_corners=True)
        lib_err = float((lib().permute(2, 3, 0, 1).reshape(R, S, -1) - ref).abs().max())
        res["E"] = dict(max_abs_err=err, ms=cuda_ms(torch, e_fn, 50),
                        plain_ms=cuda_ms(torch, e_plain, 3), bound_ms=b_ms, bound_by=b_by,
                        library_ms=cuda_ms(torch, lib, 50), library_max_abs_err=lib_err)
        e = res["E"]
        log(f"kernel E supercell_color table {list(csc.shape)} uint8 R={R} S={S}: "
            f"max|d| {err:.3e} (tol 1e-5, 0-255 scale), {e['ms']:.4f} ms vs plain "
            f"{e['plain_ms']:.3f} ms, library grid_sample {e['library_ms']:.4f} ms "
            f"(max|d| {lib_err:.3e}, tol 1e-3), bound {b_ms:.4f} ms ({b_by})")
        check_close("supercell_color", err, 1e-5)
        check_close("supercell_color vs F.grid_sample", lib_err, 1e-3)
        del got, ref, img_f

        cond, ndc0 = query_cond_info(cfg, pts, ref_w2c, ref_intr, ref_nf, tables, H, W,
                                     block_ut=block_ut, color_ut=color_ut)
        ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
        ray_ref = (ray_unit @ ref_w2c[:, 0, :3, :3].transpose(-1, -2))[:, :, None] \
            .expand(*pts.shape[:3], 3).contiguous()
        res["C"] = decoder_case(torch, kc, dev, (model.nerf_dec, cfg, ndc0.contiguous(), ray_ref,
                                                 cond, depth, ray), "DTU slice")
        del cond, pts
        # configs/test_video_own.yaml's decoder (ELU, maskfill, posenc) at S=256
        # on one 5012-ray slice of the view, through Kernel B and the colour gather
        own = test_video_own_config()
        vcfg = copy.deepcopy(cfg)
        vcfg.decoder.update({k: own.decoder[k] for k in ("raytrans_posenc", "density_maskfill",
                                                         "raytrans_act")})
        vcfg.nerf.sample_intvs = own.nerf.sample_intvs
        Rv = int(own.nerf.rand_rays_test)
        vray = ray[:, :Rv]
        vdepth = sample_depth(vcfg, tgt_nf, 1, Rv)
        vpts = camera.get_3d_points_from_depth(center[:, :Rv], vray, vdepth, multi_samples=True)
        vcond, vndc0 = query_cond_info(vcfg, vpts, ref_w2c, ref_intr, ref_nf, tables, H, W)
        vref = ray_ref[:, :Rv, :1].expand(*vpts.shape[:3], 3).contiguous()
        # the decoder built for the variant (out_alpha_linear's activation
        # is part of the module)
        vdec = init_matchnerf(vcfg, torch.Generator().manual_seed(args.seed)).nerf_dec
        vdec = vdec.to(dev).eval()
        res["C_S256"] = decoder_case(torch, kc, dev, (vdec, vcfg, vndc0.contiguous(), vref,
                                                      vcond, vdepth, vray), "test_video_own")
        del vcond, vpts, vndc0, vref, vdec
        fused_kernel_phase(torch, cfg, feats, ref_images, tables, grids, res)
        bf16_kernel_phase(torch, cfg, feats, ref_images, grids, block_ut, res)
        del feats, tables, grids

    # ---- 4. the block path (configs/test.yaml as shipped), 5. per-ray, 6. fused
    counters = {"window_attention": ka.COUNTER, "cosine_prior": kb.COUNTER,
                "cond_nerf_decode": kc.COUNTER, "block_cosine_prior": kd.COUNTER,
                "supercell_color": ke.COUNTER, "fused_cosine": kf.COUNTER,
                "window_attention_bwd": ka.BWD_COUNTER,
                "cosine_prior_bwd": kb.BWD_COUNTER,
                "block_cosine_prior_f32": kd.F32_COUNTER,
                "block_cosine_prior_bwd": kd.BWD_COUNTER}
    n_rays = H * W

    def drive(name, r, must_launch):
        for c in counters.values():
            c.reset()
        t = {}
        out = r.forward(batch, mode="test", timings=t)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        plain_cuda = {k: c.plain_on_cuda for k, c in counters.items()}
        log(f"{name} path: Renderer.forward {H}x{W} S={r.cfg.nerf.sample_intvs}, "
            f"{r.rays_per_slice(1)} rays/slice, route {r.last_route}: encode "
            f"{t['encode']:.4f} s, tables {t['tables']:.4f} s, render {t['render']:.4f} s "
            f"(pose_prep {t.get('pose_prep', 0.0):.4f} s of it), "
            f"{n_rays / t['render']:.0f} rays/s (render), "
            f"{n_rays / (t['encode'] + t['tables'] + t['render']):.0f} rays/s "
            f"(encode+tables+render)")
        log(f"{name} path: launches {launches}, plain versions on CUDA {plain_cuda}")
        for k in must_launch:
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the {name} path")
        if any(plain_cuda.values()):
            raise AssertionError(f"plain versions ran on CUDA tensors: {plain_cuda}")
        rgb = out["rgb"]
        if tuple(rgb.shape) != (1, n_rays, 3) or tuple(out["depth"].shape) != (1, n_rays, 1):
            raise AssertionError(f"output shapes {tuple(rgb.shape)} {tuple(out['depth'].shape)}")
        for k, v in out.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"non-finite {k}")
        if not (float(rgb.min()) >= -1e-6 and float(rgb.max()) <= 1.0 + 1e-6):
            raise AssertionError(f"rgb outside [0,1]: {float(rgb.min())} {float(rgb.max())}")
        return out, t, launches

    torch.cuda.reset_peak_memory_stats()
    out, timings, block_launches = drive(
        "block", renderer, ["window_attention", "cond_nerf_decode", "block_cosine_prior",
                            "supercell_color"])
    if None in renderer.last_route["block_ut"] or renderer.last_route["color_ut"] is None:
        raise AssertionError(f"block path route {renderer.last_route}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    plain_t = {}
    plain_out = plain_renderer.forward(batch, mode="test", timings=plain_t)
    torch.cuda.synchronize()
    agreement = psnr(out["rgb"], plain_out["rgb"])
    depth_err = float((out["depth"] - plain_out["depth"]).abs().max())
    log(f"block path, all plain: encode {plain_t['encode']:.4f} s, tables "
        f"{plain_t['tables']:.4f} s, render {plain_t['render']:.4f} s, "
        f"{n_rays / plain_t['render']:.0f} rays/s (render)")
    log(f"block path: agreement PSNR kernels vs plain {agreement:.2f} dB (need >= 50), "
        f"max|d| depth {depth_err:.3e}, rgb mean {float(out['rgb'].mean()):.4f}, "
        f"opacity mean {float(out['opacity'].mean()):.4f}, peak device memory "
        f"{peak_gib:.2f} GiB")
    if not agreement >= 50.0:
        raise AssertionError(f"agreement PSNR {agreement:.2f} dB < 50")
    del plain_out

    ray_out, ray_t, ray_launches = drive(
        "per-ray", per_ray_renderer, ["window_attention", "cosine_prior", "cond_nerf_decode"])
    if kc.COUNTER.by_entry != {"cond_nerf_decode_f32": ray_launches["cond_nerf_decode"]}:
        raise AssertionError(f"per-ray path: Kernel C routes {kc.COUNTER.by_entry}")
    vs_ray = psnr(out["rgb"], ray_out["rgb"])
    log(f"block path vs per-ray path: PSNR {vs_ray:.2f} dB (need >= 60)")
    if not vs_ray >= 60.0:
        raise AssertionError(f"block vs per-ray PSNR {vs_ray:.2f} dB < 60")

    # the per-ray path with precision.decoder_matmul_dtype: bf16 (Kernel C's
    # bf16 route), against its all-plain render (the bf16 plain twin)
    bf_cfg = dtu_eval_per_ray_config()
    bf_cfg.precision.decoder_matmul_dtype = "bf16"
    bf_renderer = Renderer(bf_cfg, model, dev)
    bf_out, bf_t, bf_launches = drive(
        "per-ray bf16 decoder", bf_renderer, ["window_attention", "cosine_prior",
                                              "cond_nerf_decode"])
    bf_routes = dict(kc.COUNTER.by_entry)
    if bf_routes != {"cond_nerf_decode_bf16": bf_launches["cond_nerf_decode"]}:
        raise AssertionError(f"bf16 decoder path: Kernel C routes {bf_routes}")
    bf_plain = Renderer(bf_cfg, model, dev, kernel=False).forward(batch, mode="test")
    bf_vs_plain = psnr(bf_out["rgb"], bf_plain["rgb"])
    bf_vs_f32 = psnr(bf_out["rgb"], ray_out["rgb"])
    log(f"per-ray bf16 decoder path: agreement PSNR kernels vs all-plain (bf16 twin) "
        f"{bf_vs_plain:.2f} dB (need >= 50); vs the f32 per-ray render {bf_vs_f32:.2f} dB; "
        f"Kernel C launches by route {bf_routes}")
    if not bf_vs_plain >= 50.0:
        raise AssertionError(f"bf16 decoder agreement PSNR {bf_vs_plain:.2f} dB < 50")
    del bf_plain

    fused_cfg = dtu_eval_config()
    fused_cfg.precision.fused_cosine = True
    fused_renderer = Renderer(fused_cfg, model, dev)
    fused_out, fused_t, fused_launches = drive(
        "fused", fused_renderer, ["window_attention", "cond_nerf_decode", "fused_cosine"])
    n_slices = math.ceil(n_rays / fused_renderer.rays_per_slice(1))
    if (fused_launches["fused_cosine"] != 2 * n_slices or fused_launches["cosine_prior"]
            or fused_launches["block_cosine_prior"]):
        raise AssertionError(f"fused path: F {fused_launches['fused_cosine']} launches "
                             f"(expected {2 * n_slices}), B {fused_launches['cosine_prior']} "
                             f"and D {fused_launches['block_cosine_prior']} (expected 0)")
    vs_fused = psnr(out["rgb"], fused_out["rgb"])
    log(f"fused path vs block path: PSNR {vs_fused:.2f} dB (need >= 60); render rays/s: "
        f"fused {n_rays / fused_t['render']:.0f}, block {n_rays / timings['render']:.0f}, "
        f"per-ray {n_rays / ray_t['render']:.0f}")
    if not vs_fused >= 60.0:
        raise AssertionError(f"fused vs block PSNR {vs_fused:.2f} dB < 60")

    # the f32 encoder of configs/test_strict.yaml
    strict_cfg = dtu_eval_config()
    strict_cfg.precision.strict = True
    strict = strict_encode_phase(torch, model, strict_cfg,
                                 renderer.tensor(batch["images"][:, :3]), counters)
    del out, ray_out, fused_out, bf_out
    torch.cuda.empty_cache()

    # ---- 7. the video entry: configs/demo_own.yaml (fused cosine), then
    # 8. configs/test_video_own.yaml (S = 256, 960x640)
    video = video_phase(torch, dev, args.seed, counters, args.profile, "demo_own", VIDEO_FRAMES)
    torch.cuda.empty_cache()
    video_own = video_phase(torch, dev, args.seed, counters, args.profile, "test_video_own",
                            OWN_FRAMES, OWN_PLAIN_SLICES)
    torch.cuda.empty_cache()

    # ---- 9. training kernels at training shapes, then 10. and 11. the steps
    from matchnerf_tpu_torch.config import dtu_train_config, dtu_train_fast_config
    torch.cuda.empty_cache()
    train_kernel_phase(torch, F, dev, batch, args.seed, block_ut, res)
    none = {k: 0 for k in counters}
    recipes = (
        ("train", dtu_train_config, dict(none, window_attention=12, window_attention_bwd=12,
                                         cosine_prior=2, cosine_prior_bwd=2)),
        ("train_fast", dtu_train_fast_config,
         dict(none, window_attention=12, window_attention_bwd=12, block_cosine_prior_f32=2,
              block_cosine_prior_bwd=2)))
    train = {}
    for label, make_cfg, must in recipes:
        checks = {"bf16": first_step_check(torch, dev, make_cfg(), batch, args.seed,
                                           f"{label}.yaml bf16 policy", (1e-2, 0.5, 0.1))}
        cfg32 = make_cfg()
        cfg32.precision.encoder_compute_dtype = "float32"
        cfg32.precision.decoder_compute_dtype = "float32"
        checks["f32"] = first_step_check(torch, dev, cfg32, batch, args.seed,
                                         f"{label}.yaml f32 policy", (1e-4, 1e-3, 1e-4))
        torch.cuda.empty_cache()
        train[label] = train_path(torch, dev, make_cfg(), batch, args.seed, f"{label}.yaml",
                                  counters, must, args.profile)
        train[label]["first_step"] = checks
        torch.cuda.empty_cache()
    # warm train.yaml steps under the f32 policy (Kernel A and A' in f32)
    cfg32 = dtu_train_config()
    cfg32.precision.encoder_compute_dtype = "float32"
    cfg32.precision.decoder_compute_dtype = "float32"
    train["train_f32_policy"] = train_path(torch, dev, cfg32, batch, args.seed,
                                           "train.yaml f32 policy", counters, recipes[0][2],
                                           args.profile)
    torch.cuda.empty_cache()
    route = train["train_fast"]["route"]
    if route is None or None in route:
        raise AssertionError(f"train_fast.yaml: the pose must take D' at both scales: {route}")

    # ---- 12. the training loop (train.yaml, train_fast.yaml), preemption, resume
    loop = loop_phase(torch, dev, counters)
    torch.cuda.empty_cache()

    # ---- 13. the eval entry: configs/test.yaml over DTU, LLFF and Blender,
    # test_video.yaml, test_strict.yaml
    test_entry = eval_entry_phase(torch, dev, args.seed)

    def per_scale(entries):
        return {"max_abs_err": max(e["max_abs_err"] for e in entries),
                "ms": sum(e["ms"] for e in entries),
                "plain_ms": sum(e["plain_ms"] for e in entries),
                "bound_ms": sum(e["bound_ms"] for e in entries),
                "bound_by": entries[0]["bound_by"], "scales": entries}

    def entry(name, r, launches, by_path, extra=None):
        c = counters[name]
        e = {"name": name, "route": "cuda", "source": c.source, "replaces": c.replaces,
             "launches": launches, "launches_by_path": by_path, "library_ms": None}
        e.update(r if "ms" in r else per_scale(r))
        e.update(extra or {})
        return e

    def bf16_entry(key, c_entry):
        """The bf16 form at the eval slice and the validation slice, and its
        launches per validation image (loop phase) and in the per-ray
        validation render."""
        by_r = {R: per_scale([e for e in res[f"{key}_bf16"] if e["R"] == R])
                for R in (SLICE_RAYS, VAL_RAYS)}
        name = "cosine_prior" if key == "B" else "block_cosine_prior"
        out = dict(by_r[SLICE_RAYS], **{f"R{VAL_RAYS}": by_r[VAL_RAYS]})
        out["launches_per_validation_image"] = {
            k: v["validation_routes"][key].get(c_entry, 0) for k, v in loop.items()
            if k != "preempt"}
        out["launches"] = max(out["launches_per_validation_image"].values())
        if key == "B":
            out["launches_per_ray_validation_image"] = loop["train"]["per_ray_b_bf16_launches"]
            out["launches"] = max(out["launches"], out["launches_per_ray_validation_image"])
        out.update(name=f"{name}_bf16", route="cuda", source=counters[name].source,
                   replaces=counters[name].replaces, library_ms=None)
        return out

    def eval_paths(name):
        return {"block": block_launches[name], "per_ray": ray_launches[name],
                "per_ray_bf16_decoder": bf_launches[name], "fused": fused_launches[name],
                f"video_{VIDEO_FRAMES}_frames": video["launches"][name],
                f"test_video_own_{OWN_FRAMES}_frames": video_own["launches"][name],
                **{f"test_entry_{k}": v["launches"][name] for k, v in test_entry["sets"].items()},
                **{f"test_video_{k}_{ENTRY_FRAMES}_frames": v["launches"][name]
                   for k, v in test_entry["video"].items()},
                "test_strict_dtu": test_entry["strict"]["launches"][name]}

    def by_test_set(name):
        """Device ms per launch and launches per image of one eval kernel
        in each test set's render of the eval entry (phase 13), with Kernel
        A's window shape and bound."""
        return {"test_entry": {k: dict(v["kernel_device_ms"].get(name) or {}, **(
            v["window_attention_shape"] if name == "window_attention" else {}))
            for k, v in test_entry["sets"].items()}}

    def train_paths(name):
        return {f"{k}_{TRAIN_STEPS}_steps": v["launches_total"][name] for k, v in train.items()}

    a_bwd = res["A_bwd"]
    report = {"kernels": [
        entry("window_attention", res["A_bfloat16"], block_launches["window_attention"],
              dict(eval_paths("window_attention"), **train_paths("window_attention")),
              {"f32": res["A_float32"],
               "training_forward_ms": {k: v["fwd_ms"] for k, v in a_bwd.items()},
               **by_test_set("window_attention")}),
        entry("window_attention_bwd", a_bwd["bfloat16_shift"],
              train["train"]["launches_total"]["window_attention_bwd"],
              train_paths("window_attention_bwd"), {"variants": a_bwd}),
        entry("cosine_prior", res["B"], ray_launches["cosine_prior"],
              dict(eval_paths("cosine_prior"), **train_paths("cosine_prior")),
              {"f32_training_shapes": per_scale(res["B_f32"]),
               "bfloat16": bf16_entry("B", "cosine_prior_bf16"), **by_test_set("cosine_prior")}),
        entry("cosine_prior_bwd", res["B_bwd"],
              train["train"]["launches_total"]["cosine_prior_bwd"],
              train_paths("cosine_prior_bwd")),
        entry("cond_nerf_decode", res["C"]["float32"], block_launches["cond_nerf_decode"],
              eval_paths("cond_nerf_decode"),
              {"routes": {"S128": res["C"], "S256_test_video_own": res["C_S256"]},
               "setbg_launches_blender": test_entry["sets"]["blender"]["setbg_launches"],
               **by_test_set("cond_nerf_decode")}),
        entry("block_cosine_prior", res["D"], block_launches["block_cosine_prior"],
              eval_paths("block_cosine_prior"),
              {"plain_union_ms": sum(s["plain_union_ms"] for s in res["D"]),
               "bfloat16": bf16_entry("D", "block_cosine_prior_bf16"),
               **by_test_set("block_cosine_prior")}),
        entry("block_cosine_prior_f32", res["D_f32"],
              train["train_fast"]["launches_total"]["block_cosine_prior_f32"],
              train_paths("block_cosine_prior_f32"),
              {"plain_union_ms": sum(s["plain_union_ms"] for s in res["D_f32"])}),
        entry("block_cosine_prior_bwd", res["D_bwd"],
              train["train_fast"]["launches_total"]["block_cosine_prior_bwd"],
              train_paths("block_cosine_prior_bwd")),
        entry("supercell_color", res["E"], block_launches["supercell_color"],
              eval_paths("supercell_color"), by_test_set("supercell_color")),
        entry("fused_cosine", res["F"]["int8"], video["launches"]["fused_cosine"],
              eval_paths("fused_cosine"),
              {"bfloat16": per_scale(res["F"]["bfloat16"]),
               "float32": per_scale(res["F"]["float32"]),
               "gather_ms": sum(e["gather_ms"] for e in res["F"]["int8"]),
               "max_abs_err_vs_kernel_b": max(e["max_abs_err_vs_kernel_b"]
                                              for e in res["F"]["int8"])}),
    ], "paths": {
        "block": {"encode_s": timings["encode"], "tables_s": timings["tables"],
                  "render_s": timings["render"],
                  "rays_per_s_render": n_rays / timings["render"],
                  "plain_render_s": plain_t["render"], "agreement_psnr_db": agreement,
                  "pose_prep_s": timings["pose_prep"], "route": renderer.last_route,
                  "peak_gib": peak_gib},
        "per_ray": {"encode_s": ray_t["encode"], "render_s": ray_t["render"],
                    "rays_per_s_render": n_rays / ray_t["render"],
                    "psnr_vs_block_db": vs_ray},
        "per_ray_bf16_decoder": {"render_s": bf_t["render"],
                                 "rays_per_s_render": n_rays / bf_t["render"],
                                 "agreement_psnr_db": bf_vs_plain, "psnr_vs_f32_db": bf_vs_f32},
        "fused": {"encode_s": fused_t["encode"], "render_s": fused_t["render"],
                  "rays_per_s_render": n_rays / fused_t["render"],
                  "pose_prep_s": fused_t["pose_prep"], "psnr_vs_block_db": vs_fused},
        "strict_f32_encode": strict,
        "video": {k: v for k, v in video.items() if k not in ("profile", "launches")},
        "test_video_own": {k: v for k, v in video_own.items()
                           if k not in ("profile", "launches")},
        "train": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                  for k, v in train.items()},
        "loop": loop,
        "test_entry": test_entry}}
    if args.profile:
        report["profile"] = {"train": train["train"]["profile"],
                             "train_fast": train["train_fast"]["profile"],
                             "video": video["profile"],
                             "test_video_own": video_own["profile"]}
        report["profile"].update({
            "block": profile_call(torch, "block", lambda: renderer.forward(batch, mode="test")),
            "per_ray": profile_call(torch, "per-ray",
                                    lambda: per_ray_renderer.forward(batch, mode="test")),
            "per_ray_bf16_decoder": profile_call(
                torch, "per-ray bf16 decoder", lambda: bf_renderer.forward(batch, mode="test")),
            "fused": profile_call(torch, "fused",
                                  lambda: fused_renderer.forward(batch, mode="test"))})
    log(card_line())
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
