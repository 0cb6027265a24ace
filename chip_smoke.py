#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (matchnerf_tpu_torch): the DTU eval
render on one NVIDIA card, through the three hand-written CUDA kernels.

    python3 chip_smoke.py [--seed 0]

Phases, any failure ends the run with a non-zero exit:
1. device: requires CUDA; prints the card (nvidia-smi name, power limit),
   torch and CUDA versions; builds the kernels from csrc/ (nvcc) and prints
   the build time. TF32 is switched off for matmuls and cuDNN, so every f32
   comparison is full f32.
2. scene: 4 cameras on an arc around the numpy raytracer's scene
   (matchnerf_tpu/data/synth.py, loaded by file path), 640x512 images with
   DTU-like intrinsics and near/far; the model at full width (6 transformer
   layers, 128 features, decoder width 128) from a seeded torch.Generator.
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (window attention on 24 x 1280 x 128 windows in bf16 and
   f32; the cosine prior and the decoder on a 20480-ray slice built from the
   encoder's real int8 tables), with max |d|, tolerance and CUDA-event times.
4. slice: `Renderer.forward(batch, mode="test")` renders the full 640x512
   target view at S=128; every kernel's launch count must grow and no plain
   version may run on CUDA tensors; outputs finite, rgb in [0,1]; the same
   view rendered with every kernel replaced by its plain version must agree
   at >= 50 dB PSNR.
The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
import argparse
import importlib.util
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


def make_scene(seed):
    """4 posed 640x512 views of the synthetic scene; the last is the target."""
    spec = importlib.util.spec_from_file_location(
        "synth", os.path.join(REPO, "matchnerf_tpu", "data", "synth.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
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
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float("inf") if mse == 0.0 else -10.0 * math.log10(mse)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this test runs on an NVIDIA GPU only")
    sys.path.insert(0, REPO)
    from matchnerf_tpu_torch import kernels
    from matchnerf_tpu_torch.config import dtu_eval_slice_config
    from matchnerf_tpu_torch.models.matchnerf import (init_matchnerf,
                                                      project_to_views,
                                                      query_cond_info,
                                                      sample_depth)
    from matchnerf_tpu_torch import camera
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.ops import decoder as kc
    from matchnerf_tpu_torch.ops import window_attention as ka
    from matchnerf_tpu_torch.ops.attention import shift_region_ids
    from matchnerf_tpu_torch.renderer import Renderer, extract_poses

    # ---- 1. device
    dev = torch.device("cuda", 0)
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
    cfg = dtu_eval_slice_config()
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

    # ---- 3. kernel phases at the main path's shapes
    results = {}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.no_grad():
        # A: 2 * B * P = 6 streams of the 64x80 1/8-scale map, 2x2 windows
        rid = shift_region_ids(64, 80, 2, device=dev)
        a_res = {}
        for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
            q, k, v = (torch.randn(24, 1280, 128, generator=gen, device=dev).to(dt)
                       for _ in range(3))
            got = ka.window_attention(q, k, v, rid)
            ref = ka.window_attention_plain(q, k, v, rid)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            bound = tol * max(1.0, float(ref.float().abs().max()))
            ms = cuda_ms(torch, lambda: ka.window_attention(q, k, v, rid), 10)
            plain_ms = cuda_ms(torch, lambda: ka.window_attention_plain(q, k, v, rid), 5)
            name = str(dt).replace("torch.", "")
            log(f"kernel A window_attention {name} [24,1280,128] shift-masked: "
                f"max|d| {err:.3e} (tol {bound:.3e}), {ms:.3f} ms vs plain {plain_ms:.3f} ms")
            if not err <= bound:
                raise AssertionError(f"window_attention {name}: max|d| {err} > {bound}")
            a_res[name] = (err, ms, plain_ms)
        results["window_attention"] = a_res

        # B and C on the first 20480 rays of the target view, real tables
        ref_images = renderer.tensor(batch["images"][:, :3])
        feats = renderer.encode(ref_images)
        tables = renderer.build_tables(ref_images, feats)
        poses = extract_poses(batch)
        R = 20480
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
        b_err, b_ms, b_plain_ms, b_scales = 0.0, 0.0, 0.0, []
        for s, G in enumerate(cfg.encoder.cos_n_group):
            table = tables["view_feats"][s][0]
            scales = tables["view_feat_scales"][s][0]
            got = kb.cosine_prior(table, grids, scales, G)
            ref = kb.cosine_prior_plain(table, grids, scales, G)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            ms = cuda_ms(torch, lambda: kb.cosine_prior(table, grids, scales, G), 10)
            plain_ms = cuda_ms(torch, lambda: kb.cosine_prior_plain(table, grids, scales, G), 3)
            log(f"kernel B cosine_prior scale {s} table {list(table.shape)} int8 G={G} "
                f"R={R} S={grids.shape[2]}: max|d| {err:.3e} (tol 1e-4), "
                f"{ms:.3f} ms vs plain {plain_ms:.3f} ms")
            if not err <= 1e-4:
                raise AssertionError(f"cosine_prior scale {s}: max|d| {err} > 1e-4")
            b_err, b_ms, b_plain_ms = max(b_err, err), b_ms + ms, b_plain_ms + plain_ms
            b_scales.append({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        results["cosine_prior"] = (b_err, b_ms, b_plain_ms, b_scales)

        cond, ndc0 = query_cond_info(cfg, pts, ref_w2c, ref_intr, ref_nf, tables, H, W)
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
        log(f"kernel C cond_nerf_decode R={R} S={pts.shape[2]} f32: max|d| rgb "
            f"{c_errs[0]:.3e} depth {c_errs[1]:.3e} opacity {c_errs[2]:.3e} "
            f"(tol {c_tols}), {ms:.3f} ms vs plain {plain_ms:.3f} ms")
        for name, e, t in zip(("rgb", "depth", "opacity"), c_errs, c_tols):
            if not e <= t:
                raise AssertionError(f"cond_nerf_decode {name}: max|d| {e} > {t}")
        results["cond_nerf_decode"] = (max(c_errs), ms, plain_ms, c_errs)
        del feats, tables, got, ref, cond, grids, pts

    # ---- 4. the slice: Renderer.forward on the full target view
    counters = (ka.COUNTER, kb.COUNTER, kc.COUNTER)
    for c in counters:
        c.reset()
    timings = {}
    out = renderer.forward(batch, mode="test", timings=timings)
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in counters}
    plain_cuda = {c.name: c.plain_on_cuda for c in counters}
    n_rays = H * W
    log(f"slice: Renderer.forward {H}x{W} S={cfg.nerf.sample_intvs}, "
        f"{renderer.rays_per_slice(1)} rays/slice: encode {timings['encode']:.4f} s, "
        f"tables {timings['tables']:.4f} s, render {timings['render']:.4f} s, "
        f"{n_rays / timings['render']:.0f} rays/s (render), "
        f"{n_rays / sum(timings.values()):.0f} rays/s (encode+tables+render)")
    log(f"slice: launches {launches}, plain versions on CUDA {plain_cuda}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
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

    plain_t = {}
    plain_out = plain_renderer.forward(batch, mode="test", timings=plain_t)
    torch.cuda.synchronize()
    agreement = psnr(rgb, plain_out["rgb"])
    depth_err = float((out["depth"] - plain_out["depth"]).abs().max())
    log(f"slice, all plain: encode {plain_t['encode']:.4f} s, tables "
        f"{plain_t['tables']:.4f} s, render {plain_t['render']:.4f} s, "
        f"{n_rays / plain_t['render']:.0f} rays/s (render)")
    log(f"slice: agreement PSNR kernels vs plain {agreement:.2f} dB (need >= 50), "
        f"max|d| depth {depth_err:.3e}, rgb mean {float(rgb.mean()):.4f}, "
        f"opacity mean {float(out['opacity'].mean()):.4f}")
    if not agreement >= 50.0:
        raise AssertionError(f"agreement PSNR {agreement:.2f} dB < 50")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    a = results["window_attention"]
    b = results["cosine_prior"]
    c = results["cond_nerf_decode"]
    report = {"kernels": [
        {"name": "window_attention", "route": "cuda",
         "source": "matchnerf_tpu_torch/csrc/window_attention.cu",
         "replaces": "matchnerf_tpu/ops/pallas_attention.py:44",
         "launches": launches["window_attention"],
         "max_abs_err": a["bfloat16"][0], "ms": a["bfloat16"][1],
         "plain_ms": a["bfloat16"][2],
         "f32": {"max_abs_err": a["float32"][0], "ms": a["float32"][1],
                 "plain_ms": a["float32"][2]}},
        {"name": "cosine_prior", "route": "cuda",
         "source": "matchnerf_tpu_torch/csrc/cosine_prior.cu",
         "replaces": "matchnerf_tpu/ops/pallas_banded.py:267",
         "launches": launches["cosine_prior"],
         "max_abs_err": b[0], "ms": b[1], "plain_ms": b[2], "scales": b[3]},
        {"name": "cond_nerf_decode", "route": "cuda",
         "source": "matchnerf_tpu_torch/csrc/cond_nerf_decode.cu",
         "replaces": "matchnerf_tpu/ops/pallas_decoder.py:59",
         "launches": launches["cond_nerf_decode"],
         "max_abs_err": c[0], "ms": c[1], "plain_ms": c[2],
         "max_abs_err_rgb_depth_opacity": c[3]},
    ], "slice": {"encode_s": timings["encode"], "tables_s": timings["tables"],
                 "render_s": timings["render"],
                 "rays_per_s_render": n_rays / timings["render"],
                 "plain_render_s": plain_t["render"], "agreement_psnr_db": agreement}}
    log(card_line())
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
