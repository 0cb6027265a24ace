"""Build and load the port's host library, `csrc/image_io.cpp` (the JPEG
decoder and the resampler of `data/jpeg.py` and `data/resample.py`).

The source compiles with the host C++ compiler (`$CXX`, else `g++`, else
`c++`) into ONE shared library with a plain C interface, loaded with
ctypes; ctypes releases the interpreter lock during each call, so several
threads decode and resize at once. The library lands in `build/hostio/` at
the repo root (gitignored), named by a hash of the source and flags, so an
edited source rebuilds and an unchanged one is reused. Nothing is built at
import time: `library()` builds on first use, and raises if the build
fails. It is kept apart from `kernels.py`'s CUDA library, which needs
`nvcc` and a card; this one needs neither.
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
SOURCE = PACKAGE_DIR / "csrc" / "image_io.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "hostio"
# no FMA contraction: the resampler's coefficients are rounded as Pillow's
CXX_FLAGS = ["-O2", "-std=gnu++17", "-fPIC", "-shared", "-ffp-contract=off"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long

SIGNATURES = {
    # data, n, &w, &h, &ncomp, err, errlen
    "jpeg_info": [_P, _L, _P, _P, _P, ctypes.c_char_p, _I],
    # data, n, out, w, h, ncomp, err, errlen
    "jpeg_decode": [_P, _L, _P, _I, _I, _I, ctypes.c_char_p, _I],
    # in, iw, ih, ch, out, ow, oh, filter (1 LANCZOS, 2 BILINEAR)
    "resample_u8": [_P, _I, _I, _I, _P, _I, _I, _I],
}

_lock = threading.Lock()
_lib = None


def compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no host C++ compiler (g++ or c++, or $CXX) to build "
                       f"{SOURCE.name}")


def library() -> ctypes.CDLL:
    """The host library, built from `csrc/image_io.cpp` on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        h.update(SOURCE.read_bytes())
        out = BUILD_DIR / f"libmatchnerf_hostio-{h.hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("host library build failed (%d):\n%s\n%s" % (
                    proc.returncode, " ".join(cmd), proc.stderr[-8000:]))
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
