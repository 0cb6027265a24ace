"""Where Kernel C's time goes, phase by phase, on the card; and Kernel Cg's
time at a named decoder beside C's.

    python -m matchnerf_tpu_torch.profile_decoder [--seed 0]
    python -m matchnerf_tpu_torch.profile_decoder --cg nerf_mlp [--rays 8192 --samples 128]
    python -m matchnerf_tpu_torch.profile_decoder --against DIR [--cg NAME ...]
    python -m matchnerf_tpu_torch.profile_decoder --sass

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

With --cg NAME it builds nothing extra: on random inputs at R rays x S
samples it times Kernel Cg (csrc/cond_nerf_decode_any.cu) at the decoder
CG_SHAPES[NAME] and Kernel C at the shipped decoder on the same inputs, both
operand routes, with CUDA events in turns (C, Cg, Cg, C), and prints each
kernel's milliseconds per launch, its TFLOP/s (2 per weight of the wide
layers a sample) and the card's name.

With --against DIR (another tree's csrc, e.g. from `git archive REV
matchnerf_tpu_torch/csrc`), DIR's cond_nerf_decode.cu and
cond_nerf_decode_any.cu are built into build/kernels/ with the same flags.
Kernel C runs on both builds at the eval slice and at test_video_own's,
both routes, on the same inputs: the outputs must be equal bit for bit, and
both are timed in turns (other, this, this, other). Each --cg NAME (it may
repeat) then times Kernel Cg of both builds in turns at that decoder, and
prints their max |d| and each one's against the plain twin; DIR's Cg takes
the weights as its source packs them (row-major f32 blocks, `pack_any`,
before `any_fragments`; its weight count names the layout).

With --sass, `cuobjdump -sass` counts the decoder kernels' instructions by
opcode: HMMA (tensor-core products) against FFMA (CUDA-core fused
multiply-adds), per kernel function.
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


# decoders --cg can name: config keys on top of configs/test.yaml's
CG_SHAPES = {
    "nerf_mlp": {"net_width": 256, "net_depth": 8, "posenc": {"L_3D": 10, "L_view": 4}},
    "w64_d4": {"net_width": 64, "net_depth": 4, "skip": [2]},
    "standard_gelu": {"raytrans_act": "GELU", "legacy_coord": False},
    "w512_d8": {"net_width": 512, "net_depth": 8, "posenc": {"L_3D": 10, "L_view": 4}},
}


def _events_ms(torch, fn, iters=5):
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def time_cg(name: str, R: int, S: int, seed: int):
    """Kernel Cg at CG_SHAPES[name] beside Kernel C at the shipped decoder,
    on the same random inputs: {kernel: {route: ms per launch}}."""
    import torch

    from .config import dtu_eval_config, override_options
    from .models.decoder.cond_nerf import CondNeRF
    from .ops import decoder as kc
    from .ops.nn import reset_parameters

    dev = torch.device("cuda")
    cfgs = {"C": dtu_eval_config(), "Cg": dtu_eval_config()}
    keys = dict(CG_SHAPES[name])
    cfgs["Cg"].nerf.legacy_coord = keys.pop("legacy_coord", True)
    override_options(cfgs["Cg"], {"decoder": keys}, warn=False)
    decs = {k: reset_parameters(CondNeRF(c), torch.Generator().manual_seed(seed)).to(dev).eval()
            for k, c in cfgs.items()}
    for k, dec in decs.items():
        if kc.decoder_route(dec, cfgs[k], S) != k:
            raise SystemExit(f"profile_decoder: {name} does not take Kernel {k}")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    rnd = lambda *s: torch.rand(*s, generator=g, device=dev)
    ray = torch.randn(1, R, 3, generator=g, device=dev)
    unit = (ray / ray.norm(dim=-1, keepdim=True))[:, :, None].expand(1, R, S, 3).contiguous()
    cond = {"feat_info": rnd(1, R, S, 10) * 2 - 1, "color_info": rnd(1, R, S, 9),
            "mask_info": (rnd(1, R, S, 3) > 0.4).float()}
    depth = torch.sort(rnd(1, R, S) * 2.4 + 2.1, dim=-1).values[..., None].contiguous()
    pts = rnd(1, R, S, 3) * 2 - 1
    out = {"C": {}, "Cg": {}}
    with torch.no_grad():
        for md in (torch.float32, torch.bfloat16):
            route = str(md).replace("torch.", "")
            times = {"C": [], "Cg": []}
            for k in ("C", "Cg", "Cg", "C"):
                times[k].append(_events_ms(torch, lambda: kc.cond_nerf_decode(
                    decs[k], cfgs[k], pts, unit, cond, depth, ray, matmul_dtype=md)))
            for k, t in times.items():
                wide = 2 * sum(m.weight.numel() for m in (
                    decs[k].pts_bias, *decs[k].pts_linears, decs[k].alpha_linear[0],
                    decs[k].feature_linear, decs[k].views_linears[0], decs[k].rgb_linear))
                ms = sum(t) / len(t)
                out[k][route] = ms
                print(f"Kernel {k} ({'shipped' if k == 'C' else name}, "
                      f"{list(kc.decoder_shape(decs[k]))}) R={R} S={S} {route}: "
                      f"{ms:.3f} ms per launch ({[round(x, 3) for x in t]}), "
                      f"{R * S * wide / ms / 1e9:.1f} TFLOP/s of wide products")
    print(torch.cuda.get_device_name(0))
    return out


SASS_OPCODES = ("HMMA", "FFMA", "FMUL", "FADD", "LDS", "STS", "LDG", "BAR", "SYNCS", "UBLKCP")


def sass_counts(lib_path: str) -> dict:
    """{decoder kernel function: {opcode: static count}} of a built library."""
    import collections
    import re
    from pathlib import Path
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", lib_path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed:\n{proc.stderr[-4000:]}")
    counts, fn = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "cond_nerf_decode" in m.group(1) else None
            if fn:
                counts[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn and m:
            counts[fn][m.group(1)] += 1
            counts[fn]["total"] += 1
    return {k: {op: v[op] for op in (*SASS_OPCODES, "total")} for k, v in counts.items()}


def _decode_inputs(torch, dev, R, S, seed):
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    rnd = lambda *s: torch.rand(*s, generator=g, device=dev)
    ray = torch.randn(1, R, 3, generator=g, device=dev)
    unit = (ray / ray.norm(dim=-1, keepdim=True))[:, :, None].expand(1, R, S, 3).contiguous()
    cond = {"feat_info": rnd(1, R, S, 10) * 2 - 1, "color_info": rnd(1, R, S, 9),
            "mask_info": (rnd(1, R, S, 3) > 0.3).float()}
    depth = torch.sort(rnd(1, R, S) * 2.4 + 2.1, dim=-1).values[..., None].contiguous()
    return rnd(1, R, S, 3) * 2 - 1, unit, cond, depth, ray


def against(dir_, names, R, S, seed):
    """Kernel C of this tree and of DIR bit for bit and in turns; Kernel Cg
    of both in turns at each decoder of `names` (see the docstring)."""
    import torch

    from .config import dtu_eval_config, override_options, test_video_own_config
    from .models.decoder.cond_nerf import CondNeRF
    from .models.matchnerf import init_matchnerf
    from .ops import decoder as kc
    from .ops.nn import reset_parameters
    from .profile_prior import bind, build_lib

    dev = torch.device("cuda")
    other = bind(build_lib([dir_ / "cond_nerf_decode.cu", dir_ / "cond_nerf_decode_any.cu"],
                           "libdecode_against", dir_))
    this = kernels.library()
    # DIR's Cg before its fragments took the weights as pack_any's f32 blocks
    old_cg = "n_units" not in (dir_ / "cond_nerf_decode_any.cu").read_text()

    def with_lib(lib, fn):
        saved = kernels._lib
        kernels._lib = lib
        try:
            return fn()
        finally:
            kernels._lib = saved

    def old_cg_call(dec, cfg, md, pts, unit, cond, depth, ray):
        """DIR's Cg on pack_any's blocks, called as its wrapper called it."""
        B, R_, S_, _ = pts.shape
        small, wts = (t.to(dev) for t in kc.pack_any(dec, md))
        W, D, skips, _, _, _ = kc.decoder_shape(dec)
        L3, Lv = kc._posenc_freqs(cfg)
        out = torch.empty(B * R_, 5, device=dev)
        fn = getattr(other, kc.ROUTES_ANY[md])
        err = fn(pts.data_ptr(), unit.data_ptr(), cond["feat_info"].data_ptr(),
                 cond["color_info"].data_ptr(), cond["mask_info"].data_ptr(),
                 depth.data_ptr(), ray.data_ptr(), small.data_ptr(), wts.data_ptr(),
                 kernels.ptr(kc.postab_table(S_, dev) if cfg.decoder.raytrans_posenc else None),
                 out.data_ptr(), small.numel(), wts.numel(), B * R_, S_,
                 cond["feat_info"].shape[-1], int(cfg.n_src_views), W, D,
                 sum(1 << l for l in skips), L3, Lv, int(bool(cfg.nerf.legacy_coord)),
                 kc._ACT_IDS[kc.raytrans_act_name(cfg)],
                 int(bool(cfg.decoder.density_maskfill)),
                 int(bool(cfg.nerf.wo_render_interval)), 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"DIR's Cg: CUDA error {err}")
        out = out.reshape(B, R_, 5)
        return out[..., 0:3], out[..., 3:4], out[..., 4:5]

    result = {"C": [], "Cg": []}
    with torch.no_grad():
        for label, R_, S_ in (("eval slice", 20480, 128), ("test_video_own slice", 5012, 256)):
            cfg = dtu_eval_config()
            if S_ == 256:
                own = test_video_own_config()
                for k in ("raytrans_posenc", "density_maskfill", "raytrans_act"):
                    cfg.decoder[k] = own.decoder[k]
            model = init_matchnerf(cfg, torch.Generator().manual_seed(seed)).to(dev).eval()
            pts, unit, cond, depth, ray = _decode_inputs(torch, dev, R_, S_, seed)
            for md in (torch.float32, torch.bfloat16):
                route = str(md).replace("torch.", "")
                run = lambda: kc.cond_nerf_decode(model.nerf_dec, cfg, pts, unit, cond, depth,
                                                  ray, matmul_dtype=md)
                outs = {k: with_lib(lib, run) for k, lib in (("other", other), ("this", this))}
                equal = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"]))
                times = {"other": [], "this": []}
                for k in ("other", "this", "this", "other"):
                    lib = other if k == "other" else this
                    times[k].append(with_lib(lib, lambda: _events_ms(torch, run)))
                print(f"Kernel C {label} R={R_} S={S_} {route}: bit-equal to DIR's build: "
                      f"{equal}; ms other {[round(t, 4) for t in times['other']]}, this "
                      f"{[round(t, 4) for t in times['this']]}", flush=True)
                result["C"].append({"slice": label, "route": route, "bit_equal": equal,
                                    "ms": times})
                if not equal:
                    raise AssertionError(f"Kernel C {label} {route}: not bit-equal to DIR's")
        for name in names:
            cfg = dtu_eval_config()
            keys = dict(CG_SHAPES[name])
            cfg.nerf.legacy_coord = keys.pop("legacy_coord", True)
            override_options(cfg, {"decoder": keys}, warn=False)
            dec = reset_parameters(CondNeRF(cfg), torch.Generator().manual_seed(seed)).to(dev)
            dec = dec.eval()
            pts, unit, cond, depth, ray = _decode_inputs(torch, dev, R, S, seed)
            for md in (torch.float32, torch.bfloat16):
                route = str(md).replace("torch.", "")
                runs = {"this": lambda: kc.cond_nerf_decode(dec, cfg, pts, unit, cond, depth,
                                                            ray, matmul_dtype=md)}
                runs["other"] = ((lambda: old_cg_call(dec, cfg, md, pts, unit, cond, depth,
                                                      ray)) if old_cg
                                 else (lambda: with_lib(other, runs["this"])))
                outs = {k: runs[k]() for k in ("other", "this")}
                plain = kc.cond_nerf_decode_plain(dec, cfg, pts, unit, cond, depth, ray,
                                                  matmul_dtype=md)
                err = lambda a, b: max(float((x - y).abs().max()) for x, y in zip(a, b))
                times = {"other": [], "this": []}
                for k in ("other", "this", "this", "other"):
                    times[k].append(_events_ms(torch, runs[k]))
                entry = {"decoder": name, "route": route, "R": R, "S": S, "ms": times,
                         "max_abs_this_vs_other": err(outs["this"], outs["other"]),
                         "max_abs_vs_plain": {k: err(o, plain) for k, o in outs.items()}}
                print(f"Kernel Cg {name} R={R} S={S} {route}: ms other "
                      f"{[round(t, 3) for t in times['other']]}, this "
                      f"{[round(t, 3) for t in times['this']]}; max|d| this vs other "
                      f"{entry['max_abs_this_vs_other']:.3e}, vs the plain twin "
                      f"{ {k: f'{v:.3e}' for k, v in entry['max_abs_vs_plain'].items()} }",
                      flush=True)
                result["Cg"].append(entry)
    print(torch.cuda.get_device_name(0))
    return result


def main(argv=None):
    import json
    from pathlib import Path
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cg", choices=sorted(CG_SHAPES), action="append", default=None,
                    help="time Kernel Cg at this decoder beside Kernel C (with --against: "
                         "beside DIR's Cg); may repeat")
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--against", type=Path, default=None,
                    help="a directory holding another cond_nerf_decode.cu and "
                         "cond_nerf_decode_any.cu (and their headers)")
    ap.add_argument("--sass", action="store_true",
                    help="count the decoder kernels' SASS opcodes (HMMA against FFMA)")
    args = ap.parse_args(argv)
    import torch

    from .config import dtu_eval_config, test_video_own_config
    from .models.matchnerf import init_matchnerf
    from .ops import decoder as kc

    if not torch.cuda.is_available():
        raise SystemExit("profile_decoder: needs a CUDA device")
    if args.sass:
        for fn, c in sass_counts(kernels.library()._name).items():
            print(f"sass {fn}: " + ", ".join(f"{op} {n}" for op, n in c.items()), flush=True)
    if args.against is not None:
        print(json.dumps(against(args.against, args.cg or [], args.rays, args.samples,
                                 args.seed)))
        return
    if args.cg:
        for name in args.cg:
            time_cg(name, args.rays, args.samples, args.seed)
        return
    if args.sass:
        return
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
