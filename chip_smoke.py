#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (matchnerf_tpu_torch): the DTU eval
render of configs/test.yaml, its fused-cosine route, the video entry of
configs/demo_own.yaml and the training step of configs/train.yaml and
configs/train_fast.yaml on one NVIDIA card, through the hand-written CUDA
kernels.

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
   input type) and, for Kernels A and E, one PyTorch library call computing
   the same function (scaled_dot_product_attention, grid_sample): window
   attention on 24 x 1280 x 128 windows (bf16 and f32), timed with and
   without the training forward's logsumexp, which is held against
   torch.logsumexp of the plain masked scores; on a 20480-ray slice built
   from the encoder's real tables and the pose's real unions, the per-ray
   cosine prior (B), the block-union cosine prior (D, also held against B,
   with its union sizes and buckets), the supercell colour sample (E, which
   reads no union), and the decoder (C); on the first 8192 rays (one chunk of
   the fused route), the fused interp + grouped cosine (F) on the tap rows
   of the int8 tables at both scales (also held against B) and of bf16 and
   f32 tables built from the same features, with the row gather timed
   apart.
4. block path, configs/test.yaml as shipped: `Renderer.forward(batch,
   mode="test")` renders the full 640x512 target at S=128. The pose must
   take Kernel D at both scales and Kernel E for the colours; A, C, D and E
   must launch and no plain version may run on CUDA tensors; outputs
   finite, rgb in [0,1]; the same view with every kernel replaced by its
   plain version must agree at >= 50 dB PSNR.
5. per-ray path, block_kernel off: the same view through A, B and C, which
   must each launch; it must agree with the block path at >= 60 dB.
6. fused path, configs/test.yaml with precision.fused_cosine: the same
   view with every feature scale through F (2 launches per slice), B and D
   never launched; it must agree with the block path at >= 60 dB.
7. video, configs/demo_own.yaml with precision.fused_cosine (the IBR
   decoder variant, S=128) at 256x160 on 3 source cameras of the synthetic
   scene: `Coach.test_model_video` renders the 24 frames of the interpolate
   path and writes them under build/chip_smoke/. A, C and F must launch (E
   on the frames whose colour union fits its bucket), B and D not, no plain
   version on CUDA; frames finite with rgb in [0,1]; frame 0 must agree
   with the all-plain frame at >= 50 dB. Prints frames/s and rays/s.
8. training kernels at training shapes, each against autograd through its
   plain version, on the scene's real training rays (1024 random pixels,
   or 128 8-pixel strips for D'), stratified depths and the f32 tables of
   the bf16 training encoder: A' (window attention forward with logsumexp
   and backward, bf16 and f32, shifted and not; library yardstick SDPA
   with the float mask, its backward alone and forward + backward), the B'
   table gradient per scale (and Kernel B's f32 forward at these shapes),
   D' f32 forward and backward per scale (also held against B and B', the
   same function; the largest training union is printed against its
   bucket). The A' backward also prints its TFLOP/s, counted as the
   function's 5 products (the kernels do 7); SDPA's backward, a call whose
   host work through autograd outlasts its kernels, is timed on the device
   (torch.profiler) beside its CUDA-event time.
9. configs/train.yaml step (`Coach.train_iteration`) on the 640x512 scene
   at full width, 1024 rays, S=128: a first step from one set of weights,
   rays and jitter through the kernels and all-plain (loss and per-tensor
   gradient error), with the recipe's bf16 policy and with the f32 policy;
   then 7 steps: finite losses, moving parameters, 12 A' forward, 12 A'
   backward, 2 B forward and 2 B' backward launches in each step and no
   plain version on CUDA tensors; ms per warm step and peak memory.
10. configs/train_fast.yaml step: the same, with the pose's route through
   D' at both scales (2 D' forward and 2 D' backward launches per step).
Every launch count is reset just before a path (a step, in 9 and 10) and
read just after it. With --profile, one more warm render of each eval path
and one warm step of each training recipe run under torch.profiler and
print the device time by kernel (the A' backward's dq and dkv kernels
always by name), the device busy time and the wall time.
The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
import argparse
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
H, W = 512, 640
DTU_NEAR_FAR = (2.125, 4.525)
SLICE_RAYS = 20480
TRAIN_RAYS = 1024
TRAIN_STEPS = 7                    # steps per recipe; the first is warm-up
VIDEO_FRAMES = 24                  # configs/demo_own.yaml nerf.video_n_frames
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, f32 without tensor cores


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


def bound(nbytes, flops, dtype="float32"):
    """(bound ms, 'bytes' or 'operations'): the least time for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def train_kernel_phase(torch, F, dev, batch, seed, block_ut, res):
    """Phase 6: A', B' and D' at the training shapes against autograd
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
            # forward + backward together, the kernels' and the library's
            fb_ms = cuda_ms(torch, lambda: ka.window_attention_backward(
                q, k, v, *ka.window_attention_forward(q, k, v, r, with_lse=True), do, r), 20)
            lib_fb_ms = device_ms(torch, lambda: grad(
                F.scaled_dot_product_attention(*ql, attn_mask=mask), ql, do[:, None]), 10)
            b_ms, b_by = bound(nbytes(q, k, v, out, do, lse, *gk), 5 * prod, name)
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
                f"{b_ms:.4f} ms ({b_by}, 5 products)")
            check_close(f"window_attention backward {tag}", err, tol_abs)
            res["A_bwd"][tag] = dict(max_abs_err=err, tol=tol_abs, ms=ms, tflops=tflops,
                                     autograd_ms=autograd_ms, fwd_ms=fwd_ms,
                                     plain_ms=plain_ms, library_ms=lib_ms,
                                     library_events_ms=lib_events_ms,
                                     library_max_abs_err=lib_err, fwd_bwd_ms=fb_ms,
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
        fwd_flops = N * (3 * 256 * 8 + 3 * 128 * 6)
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
                         union_ms=cuda_ms(torch, lambda: kd.block_unions(gp, h, w, ut), 10),
                         bound_ms=d_ms, bound_by=d_by, ut=ut, train_union_size=union)
        log(f"kernel D' block_cosine_prior f32 forward scale {s} G={G} R={R} S={S} (strips): "
            f"training union {union} rows vs bucket {ut} (pose_prep, eval-spaced "
            f"depths){' OVERFLOW: missing taps add 0' if union > ut else ''}; max|d| "
            f"{err:.3e} (tol 1e-5), vs kernel B {err_b:.3e} (tol 1e-5), {entry['ms']:.3f} ms "
            f"(union build {entry['union_ms']:.3f} ms of it) vs plain {entry['plain_ms']:.3f} "
            f"ms, bound {d_ms:.4f} ms ({d_by})")
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
    """Phases 7 and 8: TRAIN_STEPS steps of `Coach.train_iteration`; counts
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


def plain_frame0(cfg, model, dev, sample):
    """Frame 0 of the sample's interpolate path, every kernel replaced by
    its plain version: dict of [1, H*W, *]."""
    from matchnerf_tpu_torch.data.loader import collate
    from matchnerf_tpu_torch.renderer import Renderer, extract_poses
    plain = Renderer(cfg, model, dev, kernel=False)
    batch = collate([sample])
    poses = extract_poses(batch)
    frame0 = plain.get_video_rendering_path(poses, "interpolate", VIDEO_FRAMES, batch)[0]
    ref_images = plain.tensor(batch["images"][:, :3])
    tables = plain.build_tables(ref_images, plain.encode(ref_images))
    vw, vh = (int(x) for x in sample["img_wh"])
    return plain.render_by_slices({"tgt": frame0, "ref": poses["ref"]}, tables, vh, vw)


def video_phase(torch, dev, seed, counters, profile):
    """Phase 7: `Coach.test_model_video` of configs/demo_own.yaml with the
    fused cosine on the synthetic scene; launches counted around it; frame
    0 against the all-plain frame."""
    from matchnerf_tpu_torch.config import demo_own_config
    from matchnerf_tpu_torch.data.loader import DataLoader
    from matchnerf_tpu_torch.engine import Coach
    cfg = demo_own_config()
    cfg.precision.fused_cosine = True
    cfg.load = None
    cfg.nerf.video_n_frames = VIDEO_FRAMES
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
    frames_s = VIDEO_FRAMES / wall
    log(f"video path (demo_own.yaml, fused_cosine) Coach.test_model_video {vw}x{vh} "
        f"S={cfg.nerf.sample_intvs}, {VIDEO_FRAMES} frames, {n_slices} slices per frame: "
        f"{wall:.4f} s, {frames_s:.3f} frames/s, {frames_s * vw * vh:.0f} rays/s "
        f"(encode, tables, every frame's pose_prep and render, writing); colour union "
        f"in its bucket on {n_color} of {VIDEO_FRAMES} frames; routes of frames 0 and "
        f"{VIDEO_FRAMES - 1}: {routes[0]}, {routes[-1]}")
    log(f"video path: launches {launches}, plain versions on CUDA {plain_cuda}")
    frames = n_slices * VIDEO_FRAMES
    want = dict({k: 0 for k in counters}, window_attention=12, cond_nerf_decode=frames,
                fused_cosine=2 * frames, supercell_color=n_slices * n_color)
    if launches != want:
        raise AssertionError(f"video path launches {launches}, expected {want}")
    if any(plain_cuda.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors: {plain_cuda}")
    video = videos[0]
    if video.shape != (VIDEO_FRAMES, vh, vw, 3) or not np.isfinite(video).all():
        raise AssertionError(f"video frames {video.shape}, finite {np.isfinite(video).all()}")
    if not (video.min() >= -1e-6 and video.max() <= 1.0 + 1e-6):
        raise AssertionError(f"video rgb outside [0,1]: {video.min()} {video.max()}")
    agreement = psnr(torch.as_tensor(video[0]).reshape(1, -1, 3),
                     plain_frame0(cfg, coach.model, dev, sample)["rgb"].cpu())
    log(f"video path: frame 0 kernels vs all-plain PSNR {agreement:.2f} dB (need >= 50), "
        f"rgb mean {float(video.mean()):.4f}; outputs in {coach.output_path}")
    if not agreement >= 50.0:
        raise AssertionError(f"video frame 0 agreement PSNR {agreement:.2f} dB < 50")
    out = {"seconds": wall, "frames_per_s": frames_s, "rays_per_s": frames_s * vw * vh,
           "frames": VIDEO_FRAMES, "img_wh": [vw, vh], "slices_per_frame": n_slices,
           "color_ut_frames": n_color, "frame0_psnr_vs_plain_db": agreement,
           "launches": launches}
    if profile:
        out["profile"] = profile_call(torch, "video", coach.test_model_video)
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
    from matchnerf_tpu_torch.config import dtu_eval_config, dtu_eval_per_ray_config
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
    from matchnerf_tpu_torch.ops.nn import Linear
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
            del mask
            name = str(dt).replace("torch.", "")
            flops = 4 * 24 * 1280 * 1280 * 128
            b_ms, b_by = bound(nbytes(q, k, v, got, rid), flops, name)
            log(f"kernel A window_attention {name} [24,1280,128] shift-masked: "
                f"max|d| {err:.3e} (tol {tol_abs:.3e}), {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                f"TFLOP/s); with the logsumexp {lse_ms:.4f} ms, lse max|d| {lse_err:.3e} (tol "
                f"{lse_tol:g}); plain {plain_ms:.3f} ms, library SDPA {lib_ms:.4f} ms (max|d| "
                f"{lib_err:.3e}), bound {b_ms:.4f} ms ({b_by})")
            check_close(f"window_attention {name}", err, tol_abs)
            check_close(f"window_attention {name} logsumexp", lse_err, lse_tol)
            res[f"A_{name}"] = dict(max_abs_err=err, ms=ms, lse_ms=lse_ms, lse_max_abs_err=lse_err,
                                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                    library_ms=lib_ms)
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
            # 8 flops per (view, channel) to interpolate 4 taps and dequantise,
            # 6 per (pair, chunk channel) for the dot product and two norms
            flops = N * (3 * 256 * 8 + 3 * 128 * 6)
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
                    entry["union_ms"] = cuda_ms(
                        torch, lambda: kd.block_unions(gp, h, w, block_ut[s]), 10)
                    entry["union_size"] = kd.block_union_size_raw(gp, h, w)
                    entry["ut"] = block_ut[s]
                    entry["max_abs_err_vs_kernel_b"] = float((got - out_b).abs().max())
                    extra = (f", union {entry['union_size']} rows (bucket {block_ut[s]}), "
                             f"union build {entry['union_ms']:.3f} ms, max|d| vs kernel B "
                             f"{entry['max_abs_err_vs_kernel_b']:.3e}")
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
        ndc0 = ndc0.contiguous()
        dec_args = (model.nerf_dec, cfg, ndc0, ray_ref, cond, depth, ray)
        got = kc.cond_nerf_decode(*dec_args)
        ref = kc.cond_nerf_decode_plain(*dec_args)
        torch.cuda.synchronize()
        c_tols = (1e-4, 1e-3, 1e-4)
        c_errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
        ms = cuda_ms(torch, lambda: kc.cond_nerf_decode(*dec_args), 5)
        plain_ms = cuda_ms(torch, lambda: kc.cond_nerf_decode_plain(*dec_args), 3)
        # per sample: every linear layer (2 flops per weight) and the 4-head
        # d=4 ray attention (QK and PV over S samples)
        lin = sum(m.weight.numel() for m in model.nerf_dec.modules() if isinstance(m, Linear))
        flops = N * (2 * lin + 4 * S * 16)
        b_ms, b_by = bound(nbytes(ndc0, ray_ref, *cond.values(), depth, ray, *got), flops)
        log(f"kernel C cond_nerf_decode R={R} S={S} f32: max|d| rgb "
            f"{c_errs[0]:.3e} depth {c_errs[1]:.3e} opacity {c_errs[2]:.3e} "
            f"(tol {c_tols}), {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by}, {flops / 1e12:.3f} TFLOP)")
        for name, err, tol in zip(("rgb", "depth", "opacity"), c_errs, c_tols):
            check_close(f"cond_nerf_decode {name}", err, tol)
        res["C"] = dict(max_abs_err=max(c_errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, max_abs_err_rgb_depth_opacity=c_errs)
        del got, ref, cond, pts
        fused_kernel_phase(torch, cfg, feats, ref_images, tables, grids, res)
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
    vs_ray = psnr(out["rgb"], ray_out["rgb"])
    log(f"block path vs per-ray path: PSNR {vs_ray:.2f} dB (need >= 60)")
    if not vs_ray >= 60.0:
        raise AssertionError(f"block vs per-ray PSNR {vs_ray:.2f} dB < 60")

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
    del out, ray_out, fused_out
    torch.cuda.empty_cache()

    # ---- 7. the video entry (configs/demo_own.yaml, fused cosine)
    video = video_phase(torch, dev, args.seed, counters, args.profile)

    # ---- 8. training kernels at training shapes, then 9. and 10. the steps
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
    route = train["train_fast"]["route"]
    if route is None or None in route:
        raise AssertionError(f"train_fast.yaml: the pose must take D' at both scales: {route}")

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

    def eval_paths(name):
        return {"block": block_launches[name], "per_ray": ray_launches[name],
                "fused": fused_launches[name],
                f"video_{VIDEO_FRAMES}_frames": video["launches"][name]}

    def train_paths(name):
        return {f"{k}_{TRAIN_STEPS}_steps": v["launches_total"][name] for k, v in train.items()}

    a_bwd = res["A_bwd"]
    report = {"kernels": [
        entry("window_attention", res["A_bfloat16"], block_launches["window_attention"],
              dict(eval_paths("window_attention"), **train_paths("window_attention")),
              {"f32": res["A_float32"],
               "training_forward_ms": {k: v["fwd_ms"] for k, v in a_bwd.items()}}),
        entry("window_attention_bwd", a_bwd["bfloat16_shift"],
              train["train"]["launches_total"]["window_attention_bwd"],
              train_paths("window_attention_bwd"), {"variants": a_bwd}),
        entry("cosine_prior", res["B"], ray_launches["cosine_prior"],
              dict(eval_paths("cosine_prior"), **train_paths("cosine_prior")),
              {"f32_training_shapes": per_scale(res["B_f32"])}),
        entry("cosine_prior_bwd", res["B_bwd"],
              train["train"]["launches_total"]["cosine_prior_bwd"],
              train_paths("cosine_prior_bwd")),
        entry("cond_nerf_decode", res["C"], block_launches["cond_nerf_decode"],
              eval_paths("cond_nerf_decode")),
        entry("block_cosine_prior", res["D"], block_launches["block_cosine_prior"],
              eval_paths("block_cosine_prior"),
              {"union_ms": sum(s["union_ms"] for s in res["D"])}),
        entry("block_cosine_prior_f32", res["D_f32"],
              train["train_fast"]["launches_total"]["block_cosine_prior_f32"],
              train_paths("block_cosine_prior_f32"),
              {"union_ms": sum(s["union_ms"] for s in res["D_f32"])}),
        entry("block_cosine_prior_bwd", res["D_bwd"],
              train["train_fast"]["launches_total"]["block_cosine_prior_bwd"],
              train_paths("block_cosine_prior_bwd")),
        entry("supercell_color", res["E"], block_launches["supercell_color"],
              eval_paths("supercell_color")),
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
        "fused": {"encode_s": fused_t["encode"], "render_s": fused_t["render"],
                  "rays_per_s_render": n_rays / fused_t["render"],
                  "pose_prep_s": fused_t["pose_prep"], "psnr_vs_block_db": vs_fused},
        "video": {k: v for k, v in video.items() if k not in ("profile", "launches")},
        "train": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                  for k, v in train.items()}}}
    if args.profile:
        report["profile"] = {"train": train["train"]["profile"],
                             "train_fast": train["train_fast"]["profile"],
                             "video": video["profile"]}
        report["profile"].update({
            "block": profile_call(torch, "block", lambda: renderer.forward(batch, mode="test")),
            "per_ray": profile_call(torch, "per-ray",
                                    lambda: per_ray_renderer.forward(batch, mode="test")),
            "fused": profile_call(torch, "fused",
                                  lambda: fused_renderer.forward(batch, mode="test"))})
    log(card_line())
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
