"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/*.cu` source compiles with its own `nvcc` process, all started
together, and the objects link into ONE shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: a build takes seconds, not
minutes). The library lands in `build/kernels/` at the repo root
(gitignored), named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. Nothing is built at import time:
`library()` builds on the first kernel launch.

Each kernel module owns a `LaunchCounter`: its wrapper adds one to
`launches` (and to `by_entry` under the C launcher's name, which tells a
kernel's routes apart, and to `by_variant` under a flag the launch was
given, such as Kernel C's `setbg`) right after a launch that the CUDA
runtime accepted,
and its plain version adds one to `plain_on_cuda` whenever it runs on CUDA
tensors, so a caller can show which path a render really took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signatures of every exported launcher; each returns cudaGetLastError()
SIGNATURES = {
    # q, k, v, region_ids (or NULL), out, lse (or NULL), BW, L, C,
    # n_region_rows, stream
    "window_attention_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "window_attention_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, region_ids (or NULL), out, dout, lse, dsum scratch, dq, dk,
    # dv, BW, L, C, n_region_rows, stream
    "window_attention_bwd_f32": [_P] * 11 + [_I] * 4 + [_P],
    "window_attention_bwd_bf16": [_P] * 11 + [_I] * 4 + [_P],
    # table, grids, scales (or NULL), out, V, H, W, C, G, N, stream
    "cosine_prior_i8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "cosine_prior_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "cosine_prior_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "cosine_prior_i4": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # grids, counts, V, H, W, N, stream
    "cosine_prior_bwd_count": [_P, _P, _I, _I, _I, _I, _P],
    # table, grids, g, starts, rec, keys, V, H, W, C, G, N, stream
    "cosine_prior_bwd_f32": [_P] * 6 + [_I] * 6 + [_P],
    # sorted_keys, order, rec, d_table, R, CC, stream
    "prior_bwd_reduce_f32": [_P] * 4 + [_I, _I, _P],
    # pts, ray_unit, feat, color, mask, depth, ray, small, fragments, postab
    # (or NULL), out, fragment 16-byte units, N, S, Gf, V, act, maskfill,
    # wo_render_interval, setbg, stream
    "cond_nerf_decode_f32": [_P] * 11 + [_I] * 9 + [_P],
    "cond_nerf_decode_bf16": [_P] * 11 + [_I] * 9 + [_P],
    # pts, ray_unit, feat, color, mask, depth, ray, small, fragments, postab
    # (or NULL), out, n_small, fragment 16-byte units, N, S, Gf, V,
    # net_width, net_depth, skip_mask, L_3D, L_view, legacy, act, maskfill,
    # wo_render_interval, setbg, stream
    "cond_nerf_decode_any_f32": [_P] * 11 + [_I] * 16 + [_P],
    "cond_nerf_decode_any_bf16": [_P] * 11 + [_I] * 16 + [_P],
    # table, grids, scales (or NULL), unions_out (or NULL), out, V, H, W, C,
    # G, R, S, ut, CP, stream
    "block_cosine_prior_i8": [_P] * 5 + [_I] * 9 + [_P],
    "block_cosine_prior_f32": [_P] * 5 + [_I] * 9 + [_P],
    "block_cosine_prior_bf16": [_P] * 5 + [_I] * 9 + [_P],
    "block_cosine_prior_pair_i8": [_P] * 5 + [_I] * 9 + [_P],     # the pair layout's
    "block_cosine_prior_pair_f32": [_P] * 5 + [_I] * 9 + [_P],
    "block_cosine_prior_pair_bf16": [_P] * 5 + [_I] * 9 + [_P],
    # grids, unions, counts, V, H, W, R, S, NB, ut, CP, stream
    "block_cosine_prior_bwd_count": [_P] * 3 + [_I] * 8 + [_P],
    "block_cosine_prior_bwd_count_pair": [_P] * 3 + [_I] * 8 + [_P],
    # table, grids, unions, g, starts, rec, keys, V, H, W, C, G, R, S, NB,
    # ut, CP, stream
    "block_cosine_prior_bwd_f32": [_P] * 7 + [_I] * 10 + [_P],
    "block_cosine_prior_bwd_f32_pair": [_P] * 7 + [_I] * 10 + [_P],
    # colors_sc, grids, out, V, Hs, Ws, img_h, img_w, N (= R*S), stream
    "supercell_color_u8": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # rows, weights, scales (or NULL), out, V, C, G, N, stream
    "fused_cosine_i8": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fused_cosine_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fused_cosine_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
}


class LaunchCounter:
    """Launches of one kernel, and calls of its plain version on CUDA.
    `source` is the kernel's CUDA file and `replaces` the TPU kernel
    (file:line) it ports, both as paths in the repo."""

    def __init__(self, name: str, source: str = "", replaces: str = ""):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.plain_on_cuda = 0
        self.by_entry = {}
        self.by_variant = {}

    def reset(self):
        self.launches = 0
        self.plain_on_cuda = 0
        self.by_entry = {}
        self.by_variant = {}


_lock = threading.Lock()
_lib = None


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build matchnerf_tpu_torch's kernels")
    return found


def library() -> ctypes.CDLL:
    """The kernel library, built from `csrc/*.cu` on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        tag = _source_hash()
        out = BUILD_DIR / f"libmatchnerf_kernels-{tag}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            jobs = []
            for src in sorted(CSRC_DIR.glob("*.cu")):
                obj = BUILD_DIR / f"{src.stem}-{tag}.{os.getpid()}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                jobs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            for cmd, _, proc in jobs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    for _, _, other in jobs:
                        other.kill()
                        other.wait()
                    raise RuntimeError("nvcc failed (%d):\n%s\n%s" % (
                        proc.returncode, " ".join(cmd), err[-8000:]))
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *(str(obj) for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc link failed (%d):\n%s\n%s" % (
                    proc.returncode, " ".join(cmd), proc.stderr[-8000:]))
            for _, obj, _ in jobs:
                obj.unlink()
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def call(fn_name: str, *args) -> None:
    """Call one launcher on the current stream, uncounted (a kernel's
    helper pass, such as B' and D''s count and sum passes); raise on a
    CUDA error."""
    import torch
    fn = getattr(library(), fn_name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def launch(counter: LaunchCounter, fn_name: str, *args, variant: str = "") -> None:
    """Call one launcher on the current stream; raise on a CUDA error.
    A non-empty `variant` is counted under `counter.by_variant` too."""
    call(fn_name, *args)
    counter.launches += 1
    counter.by_entry[fn_name] = counter.by_entry.get(fn_name, 0) + 1
    if variant:
        counter.by_variant[variant] = counter.by_variant.get(variant, 0) + 1


def counters() -> dict:
    """Every kernel's `LaunchCounter` by name: the forward counters of A, B,
    C, Cg, D, E and F, and the training ones (A', B', D' and D''s f32
    forward)."""
    from .ops import block_cosine_prior as kd
    from .ops import cosine_prior as kb
    from .ops import decoder as kc
    from .ops import fused_cosine as kf
    from .ops import supercell_color as ke
    from .ops import window_attention as ka
    return {"window_attention": ka.COUNTER, "cosine_prior": kb.COUNTER,
            "cond_nerf_decode": kc.COUNTER, "cond_nerf_decode_any": kc.COUNTER_ANY,
            "block_cosine_prior": kd.COUNTER,
            "supercell_color": ke.COUNTER, "fused_cosine": kf.COUNTER,
            "window_attention_bwd": ka.BWD_COUNTER,
            "cosine_prior_bwd": kb.BWD_COUNTER,
            "block_cosine_prior_f32": kd.F32_COUNTER,
            "block_cosine_prior_bwd": kd.BWD_COUNTER}


def read(by_name: dict) -> dict:
    """{"launches": {name: n}, "plain_on_cuda": {name: n}} of the counters
    `by_name` (as `counters()` gives them) now."""
    return {"launches": {k: c.launches for k, c in by_name.items()},
            "plain_on_cuda": {k: c.plain_on_cuda for k, c in by_name.items()}}


def record_steps(coach) -> list:
    """Wrap `coach.train_iteration` (an `engine.Coach`) so that each step
    appends to the returned list what every counter counted in it,
    {"launches", "plain_on_cuda"} as `read` gives them, and the step's
    route (`coach.last_route`)."""
    by_name, steps, inner = counters(), [], coach.train_iteration

    def step(*args, **kwargs):
        before = read(by_name)
        out = inner(*args, **kwargs)
        after = read(by_name)
        steps.append({key: {k: n - before[key][k] for k, n in after[key].items()}
                      for key in after})
        steps[-1]["route"] = coach.last_route
        return out

    coach.train_iteration = step
    return steps


def ptr(t) -> int:
    """Device pointer of a tensor, or NULL for None."""
    return None if t is None else t.data_ptr()
