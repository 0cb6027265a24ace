"""Build, load and count the port's hand-written CUDA kernels.

All `csrc/*.cu` sources compile with `nvcc` into ONE shared library with a
plain C interface, loaded with ctypes (no PyTorch headers: a build takes
seconds, not minutes). The library lands in `build/kernels/` at the repo root
(gitignored), named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. Nothing is built at import time:
`library()` builds on the first kernel launch.

Each kernel module owns a `LaunchCounter`: its wrapper adds one to
`launches` right after a launch that the CUDA runtime accepted, and its plain
version adds one to `plain_on_cuda` whenever it runs on CUDA tensors, so a
caller can show which path a render really took.
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
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signatures of every exported launcher; each returns cudaGetLastError()
SIGNATURES = {
    # q, k, v, region_ids (or NULL), out, BW, L, C, n_region_rows, stream
    "window_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "window_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # table, grids, scales, out, V, H, W, C, G, N, stream
    "cosine_prior_i8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "cosine_prior_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # pts, ray_unit, feat, color, mask, depth, ray, weights, postab (or NULL),
    # out, N, S, Gf, V, act, maskfill, wo_render_interval, setbg, stream
    "cond_nerf_decode_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


class LaunchCounter:
    """Launches of one kernel, and calls of its plain version on CUDA."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_on_cuda = 0

    def reset(self):
        self.launches = 0
        self.plain_on_cuda = 0


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
        out = BUILD_DIR / f"libmatchnerf_kernels-{_source_hash()}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            sources = sorted(str(p) for p in CSRC_DIR.glob("*.cu"))
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed (%d):\n%s\n%s" % (
                    proc.returncode, " ".join(cmd), proc.stderr[-8000:]))
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def launch(counter: LaunchCounter, fn_name: str, *args) -> None:
    """Call one launcher on the current stream; raise on a CUDA error."""
    import torch
    fn = getattr(library(), fn_name)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")
    counter.launches += 1


def ptr(t) -> int:
    """Device pointer of a tensor, or NULL for None."""
    return None if t is None else t.data_ptr()
