"""PNG decoding and encoding with numpy and zlib (no PIL: the port never
imports it; it need not be installed).

`png_size` reads the image size from the header alone. `read_png` decodes 8-bit, non-interlaced greyscale (colour type 0), RGB (2)
and RGBA (6) images with any of the five row filters, and raises
`ValueError` on anything else (other bit depths, palettes, grey + alpha,
interlacing); `read_pngs` decodes several at once in worker processes.
`write_png` writes the same kinds, each row with one chosen filter or, by
default, the one libpng's adaptive heuristic picks. Both hold to the PNG
specification (ISO/IEC 15948), so the decoded pixels equal PIL's bit for
bit.

Unfiltering: Sub, Average and Paeth make each byte depend on the byte one
pixel to its left, Up and Average and Paeth on the row above. The decoder
walks the image's anti-diagonals (pixel (y, x) after (y, x-1), (y-1, x) and
(y-1, x-1)), so each step is a few numpy operations over up to min(H, W)
pixels: H + W - 1 steps for a whole image, whatever filter each row uses.
The bytes are held skewed, one anti-diagonal per contiguous slab, so a
step reads its three neighbours as slices.

The walk's many small numpy operations hold the interpreter lock, so a
loader thread decoding beside the training loop would slow the thread that
launches the step; `read_pngs` hands each image to one of DECODE_WORKERS
processes instead (started on first use, stopped at exit).
"""
from __future__ import annotations

import multiprocessing
import struct
import threading
import zlib
from concurrent.futures import ProcessPoolExecutor
from typing import List, Sequence

import numpy as np

DECODE_WORKERS = 4                     # processes of `read_pngs` (a DTU sample's views)
_pool = None
_pool_lock = threading.Lock()

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> samples per pixel


def _chunks(data: bytes):
    """(type, payload) of every chunk, CRC checked."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length or pos + 12 + length > len(data):
            raise ValueError("PNG: truncated chunk")
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) & 0xffffffff != crc:
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        yield kind, payload
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG: no IEND chunk")


def _paeth(a, b, c):
    bc, ac = b - c, a - c              # p - a, p - b for p = a + b - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """raw [H, W, bpp] uint8 filtered bytes, filters [H] (0-4) -> [H, W, bpp]
    uint8 pixels."""
    H, W, bpp = raw.shape
    if filters.size and int(filters.max()) > 4:
        raise ValueError(f"PNG: unknown filter type {int(filters.max())}")
    # pixel (y, x) at sk[y + x + 2, y + 1]: row 0 and the slots of x = -1
    # stay zero, the neighbours outside the image
    Y, X = np.indices((H, W))
    diag, row = Y + X + 2, Y + 1
    rsk = np.zeros((H + W + 1, H + 1, bpp), np.int16)
    rsk[diag, row] = raw
    sk = np.zeros_like(rsk)
    ft = np.repeat(filters[:, None], bpp, axis=1)      # [H, bpp]
    masks = {k: ft == k for k in (1, 2, 3, 4)}
    # rows_with[k][y]: the rows above y with filter k
    rows_with = {k: np.concatenate([[0], np.cumsum(filters == k)]) for k in masks}
    for d in range(H + W - 1):
        lo, hi = max(0, d - W + 1), min(H, d + 1)      # rows on this diagonal
        a = sk[d + 1, lo + 1:hi + 1]                   # left
        b = sk[d + 1, lo:hi]                           # up
        pred = np.zeros_like(a)
        for k, m in masks.items():
            if rows_with[k][hi] == rows_with[k][lo]:
                continue
            if k == 1:
                v = a
            elif k == 2:
                v = b
            elif k == 3:
                v = (a + b) >> 1
            else:
                v = _paeth(a, b, sk[d, lo:hi])         # up-left
            np.copyto(pred, v, where=m[lo:hi])
        np.bitwise_and(rsk[d + 2, lo + 1:hi + 1] + pred, 0xff, out=sk[d + 2, lo + 1:hi + 1])
    return sk[diag, row].astype(np.uint8)


def _read_filtered(path: str):
    """The filtered bytes of one PNG: ([H, W, bpp] uint8, filters [H])."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in CHANNELS or comp != 0 or filt != 0 or interlace != 0:
        raise ValueError(f"{path}: PNG with bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}; the decoder takes 8-bit non-interlaced "
                         "greyscale, RGB and RGBA")
    bpp = CHANNELS[ctype]
    stride = width * bpp + 1
    buf = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if buf.size != height * stride:
        raise ValueError(f"{path}: {buf.size} bytes of image data, expected "
                         f"{height * stride}")
    rows = buf.reshape(height, stride)
    return rows[:, 1:].reshape(height, width, bpp), rows[:, 0]


def png_size(path: str):
    """(width, height) from a PNG's IHDR chunk, the first after the
    signature, without decoding the image."""
    with open(path, "rb") as f:
        head = f.read(len(SIGNATURE) + 16)
    if not head.startswith(SIGNATURE) or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file with its IHDR first")
    return struct.unpack(">II", head[16:24])


def read_png(path: str) -> np.ndarray:
    """[H, W] uint8 (greyscale) or [H, W, 3|4] uint8 (RGB, RGBA)."""
    raw, filters = _read_filtered(path)
    img = unfilter(raw, filters)
    return img[..., 0] if img.shape[-1] == 1 else img


def read_pngs(paths: Sequence[str]) -> List[np.ndarray]:
    """`read_png` of each path, one image per worker process (one path
    decodes here). The processes are spawned: a script that calls this
    keeps its top level under `if __name__ == "__main__":`."""
    global _pool
    if len(paths) <= 1:
        return [read_png(p) for p in paths]
    with _pool_lock:
        if _pool is None:
            _pool = ProcessPoolExecutor(DECODE_WORKERS,
                                        mp_context=multiprocessing.get_context("spawn"))
    return list(_pool.map(read_png, paths))


def filter_rows(img: np.ndarray, ftype="adaptive") -> np.ndarray:
    """[H, W, bpp] uint8 -> [H, 1 + W*bpp] uint8 rows with filter `ftype`
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), one for every row, a
    sequence of H, one per row, or "adaptive": each row the filter whose
    bytes, read as signed, have the least sum of absolute values (libpng's
    heuristic), so rows mix filters as most encoders write them."""
    H, W, bpp = img.shape
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)])
    res = ((x - preds) & 0xff).astype(np.uint8)        # [5, H, W, bpp]
    if isinstance(ftype, str) and ftype == "adaptive":
        ft = np.abs(res.astype(np.int8).astype(np.int32)).sum((2, 3)).argmin(0)
    else:
        ft = np.broadcast_to(np.asarray(ftype, np.int64), (H,))
        if int(ft.max()) > 4:
            raise ValueError(f"PNG filter types are 0-4, got {int(ft.max())}")
    body = res[ft, np.arange(H)].reshape(H, W * bpp)
    return np.concatenate([ft.astype(np.uint8)[:, None], body], axis=1)


def write_png(path: str, img: np.ndarray, ftype="adaptive"):
    """Write [H, W] or [H, W, 1|3|4] uint8 as an 8-bit PNG with the row
    filters `ftype` of `filter_rows` (default: chosen per row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    bpp = img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(bpp)
    if img.ndim != 3 or ctype is None:
        raise ValueError(f"write_png: image {img.shape}")
    H, W = img.shape[:2]

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xffffffff))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)
    idat = zlib.compress(filter_rows(img, ftype).tobytes(), 6)
    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", idat) + chunk(b"IEND", b""))
