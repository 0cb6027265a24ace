"""Kernels A and A' on the card, against another build of their source.

    python -m matchnerf_tpu_torch.profile_attention [--against OTHER.cu] [--ptxas]

Times the window attention at the encoder's shape [24, 1280, 128], f32 and
bf16, unmasked and shift-masked: the forward alone (eval), the forward with
the logsumexp (training) and the backward kernels alone, with CUDA events
over 20 calls after two warm-up calls; beside them
`F.scaled_dot_product_attention` with the -100 region mask as a float mask
(forward by CUDA events, backward by its device time under torch.profiler,
with the names of the kernels it runs), each one's max |d| against the plain
version, and the bound at the operand type's tensor-core rate (split TF32:
495/3 TFLOP/s for f32; bf16 989). With `--against`, another version of
csrc/window_attention.cu (for example the parent commit's, from
`git show REV:matchnerf_tpu_torch/csrc/window_attention.cu`) is built into
build/kernels/ with the same flags and timed in the same process, in turns
(other, this, this, other), so the two are compared on one card. With
`--ptxas`, nvcc's register, shared-memory and spill report for this tree's
source is printed first. With `--mma-peak`, the rate of mma.sync m16n8k8 on
TF32 operands alone is measured first (8 independent accumulator tiles a
warp, 4, 8 and 16 warps on each of the card's SMs): the ceiling of the f32
kernels' products, which wgmma alone would raise. Prints the card's name and power limit and, as its
last line, one JSON object with every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

from . import kernels

BW, L, CH = 24, 1280, 128
ITERS = 20
HBM_BYTES_PER_S = 3.35e12
# tensor-core rates of the kernels' operand routes: split TF32 is three
# TF32 products (495 TFLOP/s) for each f32 one
TC_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
ENTRIES = ("window_attention_f32", "window_attention_bf16", "window_attention_bwd_f32",
           "window_attention_bwd_bf16")


def card_line():
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def build_other(src: Path) -> ctypes.CDLL:
    """Another version of the window attention source as its own library."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / "libwindow_attention_against.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-8000:]}")
    lib = ctypes.CDLL(str(out))
    for name in ENTRIES:
        getattr(lib, name).argtypes = kernels.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


MMA_PEAK_SRC = r"""
#include <cstdint>
__global__ void mma_peak_kernel(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u}, b0 = threadIdx.x * 5u, b1 = 11u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak(void* out, int blocks, int threads, int iters, void* stream) {
  mma_peak_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_peak(torch) -> list:
    """(warps per SM, TFLOP/s) of mma.sync m16n8k8 TF32 products alone."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = kernels.BUILD_DIR / "mma_peak.cu"
    src.write_text(MMA_PEAK_SRC)
    lib_path = kernels.BUILD_DIR / "libmma_peak.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                           str(lib_path), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-8000:]}")
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    lib.mma_peak.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 16 * 32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows, iters = [], 20000
    for warps in (4, 8, 16):
        if lib.mma_peak(out.data_ptr(), sms, 32 * warps, 10, stream) != 0:
            raise RuntimeError("mma_peak: launch failed")
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        lib.mma_peak(out.data_ptr(), sms, 32 * warps, iters, stream)
        e1.record()
        torch.cuda.synchronize()
        flops = sms * warps * iters * 8 * 2 * 16 * 8 * 8
        rows.append((warps, flops / e0.elapsed_time(e1) / 1e9))
    return rows


def ptxas_report() -> list:
    """(kernel, registers, spill stores, spill loads) per kernel of this
    tree's window_attention.cu."""
    obj = kernels.BUILD_DIR / "window_attention_ptxas.o"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
           str(kernels.CSRC_DIR / "window_attention.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-8000:]}")
    rows, name, spill = [], None, (0, 0)
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?(window_attention_\w+?_kernel)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another version of csrc/window_attention.cu to time beside this one")
    ap.add_argument("--ptxas", action="store_true", help="print nvcc's register report first")
    ap.add_argument("--mma-peak", action="store_true",
                    help="measure mma.sync's TF32 rate alone first")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from .ops import window_attention as ka
    from .ops.attention import shift_region_ids

    if not torch.cuda.is_available():
        raise SystemExit("profile_attention: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    result = {"card": card, "shape": [BW, L, CH]}
    if args.ptxas:
        result["ptxas"] = ptxas_report()
        for row in result["ptxas"]:
            print("ptxas %-36s %3d registers, spill stores %d B, loads %d B" % row, flush=True)
    if args.mma_peak:
        result["mma_peak_tflops"] = mma_peak(torch)
        for warps, tflops in result["mma_peak_tflops"]:
            print(f"mma.sync m16n8k8 TF32 alone, {warps} warps an SM: {tflops:.1f} TFLOP/s",
                  flush=True)
    libs = {"this": kernels.library()}
    if args.against is not None:
        libs["other"] = build_other(args.against)
    order = ["other", "this", "this", "other"] if "other" in libs else ["this"]

    def call(lib, name, *a):
        err = getattr(lib, name)(*a, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def events_ms(fn):
        for _ in range(2):
            fn()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        for _ in range(ITERS):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / ITERS

    def device_ms(fn):
        """Device time per call and the kernels' names, under torch.profiler."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_time_total > 0]
        return (sum(e.device_time_total for e in evs) / 1e3 / ITERS,
                sorted({e.key[:120] for e in evs}))

    gen = torch.Generator(device=dev).manual_seed(0)
    rid_all = shift_region_ids(64, 80, 2, device=dev)
    prod = 2 * BW * L * L * CH                   # flops of one score-sized product
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        suffix = "f32" if dt == torch.float32 else "bf16"
        for shift in (False, True):
            rid = rid_all if shift else None
            n_rid = 0 if rid is None else rid.shape[0]
            q, k, v, do = (torch.randn(BW, L, CH, generator=gen, device=dev).to(dt)
                           for _ in range(4))
            out = torch.empty_like(q)
            lse = torch.empty(BW, L, device=dev)
            dsum = torch.empty(BW, L, device=dev)
            grads = [torch.empty_like(q) for _ in range(3)]
            rp = kernels.ptr(rid)
            fwd = lambda lib, with_lse: call(lib, f"window_attention_{suffix}", q.data_ptr(),
                                             k.data_ptr(), v.data_ptr(), rp, out.data_ptr(),
                                             lse.data_ptr() if with_lse else None, BW, L, CH,
                                             n_rid)
            bwd = lambda lib: call(lib, f"window_attention_bwd_{suffix}", q.data_ptr(),
                                   k.data_ptr(), v.data_ptr(), rp, out.data_ptr(),
                                   do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                                   *(g.data_ptr() for g in grads), BW, L, CH, n_rid)
            # correctness of each library against the plain version first
            qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
            ref = ka.window_attention_plain(qp, kp, vp, rid)
            ref_grads = torch.autograd.grad(ref, (qp, kp, vp), do)
            gmax = max(float(g.float().abs().max()) for g in ref_grads)
            errs = {}
            for key, lib in libs.items():
                fwd(lib, True)
                bwd(lib)
                torch.cuda.synchronize()
                errs[key] = {"out": float((out.float() - ref.float()).abs().max()),
                             "grads_rel": max(float((a.float() - b.float()).abs().max())
                                              for a, b in zip(grads, ref_grads)) / gmax}
            times = {key: {"fwd": [], "fwd_lse": [], "bwd": []} for key in libs}
            for key in order:
                lib = libs[key]
                times[key]["fwd"].append(events_ms(lambda: fwd(lib, False)))
                times[key]["fwd_lse"].append(events_ms(lambda: fwd(lib, True)))
                fwd(lib, True)
                times[key]["bwd"].append(events_ms(lambda: bwd(lib)))
            # the library yardstick
            mask = None
            if rid is not None:
                rows = rid[torch.arange(BW, device=dev) % n_rid]
                mask = torch.where(rows[:, :, None] != rows[:, None, :], -100.0, 0.0)
                mask = mask[:, None].to(dt)
            ql = [t[:, None].detach().clone().requires_grad_() for t in (q, k, v)]
            with torch.no_grad():
                sdpa = lambda: F.scaled_dot_product_attention(*ql, attn_mask=mask)
                sdpa_fwd_ms = events_ms(sdpa)
                sdpa_fwd_dev, sdpa_fwd_kernels = device_ms(sdpa)
                sdpa_err = float((sdpa()[:, 0].float() - ref.float()).abs().max())
            outl = F.scaled_dot_product_attention(*ql, attn_mask=mask)
            gl = torch.autograd.grad(outl, ql, do[:, None], retain_graph=True)
            sdpa_grad_rel = max(float((a[:, 0].float() - b.float()).abs().max())
                                for a, b in zip(gl, ref_grads)) / gmax
            sdpa_bwd_dev, sdpa_bwd_kernels = device_ms(
                lambda: torch.autograd.grad(outl, ql, do[:, None], retain_graph=True))
            b_fwd = max(nbytes_ms(q, 4), 2 * prod / TC_FLOPS[name] * 1e3)
            b_bwd = max(nbytes_ms(q, 8), 5 * prod / TC_FLOPS[name] * 1e3)
            tag = f"{name}_{'shift' if shift else 'noshift'}"
            entry = {"max_abs_err": errs, "ms": times, "sdpa_fwd_ms": sdpa_fwd_ms,
                     "sdpa_fwd_device_ms": sdpa_fwd_dev, "sdpa_fwd_kernels": sdpa_fwd_kernels,
                     "sdpa_out_max_abs_err": sdpa_err, "sdpa_bwd_device_ms": sdpa_bwd_dev,
                     "sdpa_bwd_kernels": sdpa_bwd_kernels, "sdpa_grads_rel_err": sdpa_grad_rel,
                     "bound_fwd_ms": b_fwd, "bound_bwd_ms": b_bwd,
                     "tflops_fwd_this": 2 * prod / min(times["this"]["fwd"]) / 1e9,
                     "tflops_bwd_this": 5 * prod / min(times["this"]["bwd"]) / 1e9}
            result[tag] = entry
            fmt = lambda xs: " / ".join(f"{x:.4f}" for x in xs)
            for key in libs:
                t = times[key]
                print(f"{tag} {key}: forward {fmt(t['fwd'])} ms, with logsumexp "
                      f"{fmt(t['fwd_lse'])} ms, backward {fmt(t['bwd'])} ms; max|d| out "
                      f"{errs[key]['out']:.3e}, grads {errs[key]['grads_rel']:.3e} of the "
                      f"largest", flush=True)
            print(f"{tag} SDPA: forward {sdpa_fwd_ms:.4f} ms (device {sdpa_fwd_dev:.4f}), "
                  f"backward device {sdpa_bwd_dev:.4f} ms; max|d| out {sdpa_err:.3e}, grads "
                  f"{sdpa_grad_rel:.3e}; bound forward {b_fwd:.4f} ms, backward "
                  f"{b_bwd:.4f} ms at {TC_FLOPS[name] / 1e12:.0f} TFLOP/s", flush=True)
            print(f"{tag} SDPA kernels: forward {sdpa_fwd_kernels}, backward "
                  f"{sdpa_bwd_kernels}", flush=True)
            del q, k, v, do, out, grads, qp, kp, vp, ref, ref_grads, ql, outl, gl, mask
            torch.cuda.empty_cache()
    print(card_line(), flush=True)
    print(json.dumps(result), flush=True)


def nbytes_ms(t, n_arrays):
    """The time to move n_arrays tensors of t's size at the memory rate."""
    return n_arrays * t.numel() * t.element_size() / HBM_BYTES_PER_S * 1e3


if __name__ == "__main__":
    sys.exit(main())
