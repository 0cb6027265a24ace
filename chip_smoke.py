#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (matchnerf_tpu_torch): the DTU eval
render of configs/test.yaml on one NVIDIA card, through the five
hand-written CUDA kernels.

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
   attention on 24 x 1280 x 128 windows (bf16 and f32); on a 20480-ray
   slice built from the encoder's real tables and the pose's real unions,
   the per-ray cosine prior (B), the block-union cosine prior (D, also held
   against B) and the supercell colour sample (E) with their union sizes
   and buckets, and the decoder (C).
4. block path, configs/test.yaml as shipped: `Renderer.forward(batch,
   mode="test")` renders the full 640x512 target at S=128. The pose must
   take Kernel D at both scales and Kernel E for the colours; A, C, D and E
   must launch and no plain version may run on CUDA tensors; outputs
   finite, rgb in [0,1]; the same view with every kernel replaced by its
   plain version must agree at >= 50 dB PSNR.
5. per-ray path, block_kernel off: the same view through A, B and C, which
   must each launch; it must agree with the block path at >= 60 dB.
Every launch count is reset just before a path and read just after it.
With --profile, one more warm render of each path runs under
torch.profiler and prints the device time by kernel, the device busy time
and the wall time.
The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
import argparse
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


def profile_render(torch, name, renderer, batch, top=12):
    """One warm Renderer.forward under torch.profiler: device time by
    kernel (top `top`), summed device time, and the wall time around it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        renderer.forward(batch, mode="test")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    if not rows:       # older profilers report device time on the CPU-side ops
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"profile {name}: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100.0 * (1.0 - busy / (wall * 1e3)):.1f} % idle)")
    for key, ms, count in rows[:top]:
        log(f"profile {name}:   {ms:9.2f} ms  {count:5d}x  {key[:100]}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "top": [[k[:100], ms, c] for k, ms, c in rows[:top]]}


def check_close(name, err, tol):
    if not err <= tol:
        raise AssertionError(f"{name}: max|d| {err} > {tol}")


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
        for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
            q, k, v = (torch.randn(24, 1280, 128, generator=gen, device=dev).to(dt)
                       for _ in range(3))
            got = ka.window_attention(q, k, v, rid)
            ref = ka.window_attention_plain(q, k, v, rid)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            tol_abs = tol * max(1.0, float(ref.float().abs().max()))
            ms = cuda_ms(torch, lambda: ka.window_attention(q, k, v, rid), 10)
            plain_ms = cuda_ms(torch, lambda: ka.window_attention_plain(q, k, v, rid), 5)
            # library yardstick: SDPA with the -100 region mask as a float mask
            rows = rid[torch.arange(24, device=dev) % rid.shape[0]]
            mask = torch.where(rows[:, :, None] != rows[:, None, :], -100.0, 0.0)
            mask = mask[:, None].to(dt)
            lib = lambda: F.scaled_dot_product_attention(q[:, None], k[:, None],
                                                         v[:, None], attn_mask=mask)
            lib_err = float((lib()[:, 0].float() - ref.float()).abs().max())
            lib_ms = cuda_ms(torch, lib, 10)
            del mask
            name = str(dt).replace("torch.", "")
            b_ms, b_by = bound(nbytes(q, k, v, got, rid), 4 * 24 * 1280 * 1280 * 128, name)
            log(f"kernel A window_attention {name} [24,1280,128] shift-masked: "
                f"max|d| {err:.3e} (tol {tol_abs:.3e}), {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
                f"library SDPA {lib_ms:.3f} ms (max|d| {lib_err:.3e}), "
                f"bound {b_ms:.4f} ms ({b_by})")
            check_close(f"window_attention {name}", err, tol_abs)
            res[f"A_{name}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

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
        e_fn = lambda: ke.supercell_color_sample(csc, grids, H, W, color_ut)
        e_plain = lambda: ke.supercell_color_sample_plain(csc, grids, H, W, color_ut)
        got, ref = e_fn(), e_plain()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        # 9 flops per (sample, view, colour): two y blends and one x blend
        b_ms, b_by = bound(nbytes(csc, grids, got), N * 3 * 3 * 9)
        gp = kd.pad_rays(grids)
        # library yardstick: F.grid_sample (bilinear, border, align_corners)
        # on the source images as f32 on the 0-255 scale, [V,3,R,S]
        img_f = tables["colors"][0].permute(0, 3, 1, 2).float().contiguous()
        lib = lambda: F.grid_sample(img_f, grids, mode="bilinear", padding_mode="border",
                                    align_corners=True)
        lib_err = float((lib().permute(2, 3, 0, 1).reshape(R, S, -1) - ref).abs().max())
        res["E"] = dict(max_abs_err=err, ms=cuda_ms(torch, e_fn, 10),
                        plain_ms=cuda_ms(torch, e_plain, 3), bound_ms=b_ms, bound_by=b_by,
                        library_ms=cuda_ms(torch, lib, 10), library_max_abs_err=lib_err,
                        union_ms=cuda_ms(torch, lambda: ke.color_unions(gp, H, W, color_ut),
                                         10),
                        union_size=ke.color_union_size(gp, H, W), ut=color_ut)
        e = res["E"]
        log(f"kernel E supercell_color table {list(csc.shape)} uint8 R={R} S={S}: "
            f"max|d| {err:.3e} (tol 1e-4, 0-255 scale), {e['ms']:.3f} ms vs plain "
            f"{e['plain_ms']:.3f} ms, library grid_sample {e['library_ms']:.3f} ms "
            f"(max|d| {lib_err:.3e}, tol 1e-3), bound {b_ms:.4f} ms ({b_by}), union "
            f"{e['union_size']} supercells (bucket {color_ut}), union build "
            f"{e['union_ms']:.3f} ms")
        check_close("supercell_color", err, 1e-4)
        check_close("supercell_color vs F.grid_sample", lib_err, 1e-3)
        del got, ref, gp, img_f

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
        del feats, tables, got, ref, cond, grids, pts

    # ---- 4. the block path (configs/test.yaml as shipped), then 5. per-ray
    counters = {"window_attention": ka.COUNTER, "cosine_prior": kb.COUNTER,
                "cond_nerf_decode": kc.COUNTER, "block_cosine_prior": kd.COUNTER,
                "supercell_color": ke.COUNTER}
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

    def entry(name, key, launches, extra=None):
        c = counters[name]
        r = res[key] if isinstance(res[key], dict) else {
            "max_abs_err": max(s["max_abs_err"] for s in res[key]),
            "ms": sum(s["ms"] for s in res[key]),
            "plain_ms": sum(s["plain_ms"] for s in res[key]),
            "bound_ms": sum(s["bound_ms"] for s in res[key]),
            "bound_by": res[key][0]["bound_by"], "scales": res[key]}
        e = {"name": name, "route": "cuda", "source": c.source, "replaces": c.replaces,
             "launches": launches,
             "launches_by_path": {"block": block_launches[name],
                                  "per_ray": ray_launches[name]},
             "library_ms": None}
        e.update(r)
        e.update(extra or {})
        return e

    report = {"kernels": [
        entry("window_attention", "A_bfloat16", block_launches["window_attention"],
              {"f32": res["A_float32"]}),
        entry("cosine_prior", "B", ray_launches["cosine_prior"]),
        entry("cond_nerf_decode", "C", block_launches["cond_nerf_decode"]),
        entry("block_cosine_prior", "D", block_launches["block_cosine_prior"],
              {"union_ms": sum(s["union_ms"] for s in res["D"])}),
        entry("supercell_color", "E", block_launches["supercell_color"]),
    ], "paths": {
        "block": {"encode_s": timings["encode"], "tables_s": timings["tables"],
                  "render_s": timings["render"],
                  "rays_per_s_render": n_rays / timings["render"],
                  "plain_render_s": plain_t["render"], "agreement_psnr_db": agreement,
                  "pose_prep_s": timings["pose_prep"], "route": renderer.last_route,
                  "peak_gib": peak_gib},
        "per_ray": {"encode_s": ray_t["encode"], "render_s": ray_t["render"],
                    "rays_per_s_render": n_rays / ray_t["render"],
                    "psnr_vs_block_db": vs_ray}}}
    if args.profile:
        report["profile"] = {"block": profile_render(torch, "block", renderer, batch),
                             "per_ray": profile_render(torch, "per-ray", per_ray_renderer,
                                                       batch)}
    log(card_line())
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
