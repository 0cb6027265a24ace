"""JPEG decoding without PIL (the port never imports it; it need not be
installed).

`read_jpeg(path)` returns exactly `np.asarray(Image.open(path))`: RGB uint8
[H,W,3], or L uint8 [H,W] for a one-component file. The decoder is C++ in
the port's host library (`csrc/image_io.cpp`, built by `hostio.py`):
Huffman decoding is serial, seconds per 1080p image in Python. It takes
baseline, extended sequential and progressive Huffman frames (SOF0, SOF1,
SOF2) with 8-bit samples, 1 or 3 components with sampling factors up to
2x2 (4:4:4, 4:2:2, 4:2:0, 4:4:0), interleaved and non-interleaved scans,
restart intervals, optimised Huffman tables, 8- and 16-bit quantisation
tables, and skips APPn and COM segments; Adobe APP14's transform flag (or
JFIF, or the component ids) decides between YCbCr and RGB as libjpeg
decides. Progressive files may use spectral selection, successive
approximation and EOB runs, in any order libjpeg accepts (a bogus
progression, such as a refinement scan repeated, decodes as libjpeg
decodes it). It computes what libjpeg-turbo computes with the defaults PIL
leaves it: the ISLOW integer IDCT with the 16-bit arithmetic of its x86
SIMD version, fancy upsampling, fixed-point YCbCr -> RGB, and, for a
progressive file whose scans leave some of the first AC coefficients
unrefined, libjpeg-turbo 3.1's block smoothing; damaged scan data (cut,
misnumbered restart markers) decodes as libjpeg decodes it. Lossless,
hierarchical and arithmetic-coded files, 12-bit samples, CMYK, malformed
progressive scans (Ss > Se, an AC scan of several components, ...) and
truncated files raise a `ValueError` that names the file and the marker or
the scan.

`jpeg_size(path)` reads (width, height) from the frame header alone.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import hostio

JPEG_EXTENSIONS = (".jpg", ".jpeg")


def is_jpeg(path: str) -> bool:
    return path.lower().endswith(JPEG_EXTENSIONS)


def _frame(data: bytes, name: str):
    """(width, height, components) from the frame header, read by the host
    library without decoding (any SOFn: a progressive file's size reads too)."""
    dims = [ctypes.c_int() for _ in range(3)]
    err = ctypes.create_string_buffer(512)
    if hostio.library().jpeg_info(data, len(data), *map(ctypes.byref, dims), err,
                                  len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return tuple(d.value for d in dims)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG file bytes -> uint8 [H,W,3] (RGB) or [H,W] (L), as PIL decodes
    them; `name` goes into the error message."""
    w, h, nc = _frame(data, name)
    out = np.empty((h, w, nc) if nc > 1 else (h, w), np.uint8)
    err = ctypes.create_string_buffer(512)
    if hostio.library().jpeg_decode(data, len(data), out.ctypes.data, w, h, nc, err,
                                    len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """`np.asarray(Image.open(path))` of a JPEG file."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def jpeg_size(path: str):
    """(width, height) of a JPEG from its frame header."""
    with open(path, "rb") as f:
        return _frame(f.read(), path)[:2]
