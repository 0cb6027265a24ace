"""Where Kernel C's time goes, phase by phase, on the card.

    python -m matchnerf_tpu_torch.profile_decoder [--seed 0]

Builds csrc/cond_nerf_decode.cu once more with -DKERNEL_C_PHASES (clock64
marks kept by threads 0 and 128 of every block; the kernel the port runs
has none) into build/kernels/, runs both operand routes at the eval slice
(20480 rays x S=128, flagship decoder) and at configs/test_video_own.yaml's
(5012 x 256, its decoder) on random inputs, and prints the mean cycles per
block in each phase: the tile's input staging, pts_bias with the encoding,
layers 0-5, the heads (alpha, feature, views, rgb), the wait before the ray
tail, q/k/v with the next ray's L2 prefetch, the attention, fc/LayerNorm/
density, the composite, and the waits on the weight ring. The CUDA-event
time beside them includes the marks' own cost.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess

from . import kernels

PHASES = ["staging", "pts_bias + encoding", "layers 0-5", "alpha, feature, views, rgb",
          "wait before the ray tail", "q, k, v (+ prefetch)", "attention",
          "fc, LayerNorm, density", "", "composite", "ring: waits for a group",
          "ring: waits for a free slot (thread 0)"]


def build():
    """The instrumented kernel library (one source, plain C interface)."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / "libcond_nerf_decode_phases.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DKERNEL_C_PHASES", "-shared", "-o",
           str(out), str(kernels.CSRC_DIR / "cond_nerf_decode.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-8000:]}")
    lib = ctypes.CDLL(str(out))
    for name in ("cond_nerf_decode_f32", "cond_nerf_decode_bf16"):
        getattr(lib, name).argtypes = kernels.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.cond_nerf_decode_phases.argtypes = [ctypes.c_void_p]
    lib.cond_nerf_decode_phases.restype = ctypes.c_int
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    from .config import dtu_eval_config, test_video_own_config
    from .models.matchnerf import init_matchnerf
    from .ops import decoder as kc

    if not torch.cuda.is_available():
        raise SystemExit("profile_decoder: needs a CUDA device")
    dev = torch.device("cuda")
    lib = build()
    saved, kernels._lib = kernels._lib, lib
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        for label, R, S in (("eval slice", 20480, 128), ("test_video_own slice", 5012, 256)):
            cfg = dtu_eval_config()
            if S == 256:
                own = test_video_own_config()
                for k in ("raytrans_posenc", "density_maskfill", "raytrans_act"):
                    cfg.decoder[k] = own.decoder[k]
            model = init_matchnerf(cfg, torch.Generator().manual_seed(args.seed)).to(dev).eval()
            g = torch.Generator(device=dev).manual_seed(args.seed + 1)
            rnd = lambda *s: torch.rand(*s, generator=g, device=dev)
            ray = torch.randn(1, R, 3, generator=g, device=dev)
            unit = (ray / ray.norm(dim=-1, keepdim=True))[:, :, None].expand(1, R, S, 3)
            cond = {"feat_info": rnd(1, R, S, 10) * 2 - 1, "color_info": rnd(1, R, S, 9),
                    "mask_info": (rnd(1, R, S, 3) > 0.3).float()}
            depth = torch.sort(rnd(1, R, S) * 2.4 + 2.1, dim=-1).values[..., None]
            dargs = (model.nerf_dec, cfg, rnd(1, R, S, 3) * 2 - 1, unit.contiguous(), cond,
                     depth.contiguous(), ray)
            for md in (torch.float32, torch.bfloat16):
                with torch.no_grad():
                    kc.cond_nerf_decode(*dargs, matmul_dtype=md)
                    torch.cuda.synchronize()
                    buf = (ctypes.c_ulonglong * 64)()
                    lib.cond_nerf_decode_phases(buf)          # zero
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    kc.cond_nerf_decode(*dargs, matmul_dtype=md)
                    e1.record()
                    torch.cuda.synchronize()
                    lib.cond_nerf_decode_phases(buf)
                blocks = min(R, sms)
                total = sum(buf[k] for k in range(10))
                print(f"{label} R={R} S={S} {str(md).replace('torch.', '')}: "
                      f"{e0.elapsed_time(e1):.3f} ms with the marks; cycles per block "
                      f"(thread 0, thread 128), share of thread 0's {total / blocks:.0f}:")
                for k, name in enumerate(PHASES):
                    if name:
                        print(f"  {name:40s} {buf[k] / blocks:12.0f} {buf[k + 32] / blocks:12.0f}"
                              f"  {100.0 * buf[k] / max(total, 1):5.1f} %")
    finally:
        kernels._lib = saved
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
