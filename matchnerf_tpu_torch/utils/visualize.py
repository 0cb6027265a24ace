"""Image and video output (counterpart of matchnerf_tpu/utils/visualize.py)
that needs no imaging package: PNG through the standard library (zlib and
struct); mp4 and GIF through imageio only where it is importable, and
otherwise the frames as one uint8 `.npy` stack.
"""
from __future__ import annotations

import logging
import os
import struct
import zlib
from typing import List, Optional

import numpy as np

log = logging.getLogger(__name__)


def _png_bytes(img: np.ndarray) -> bytes:
    """uint8 RGB [H,W,3] -> the bytes of a PNG file (8-bit truecolour, each
    row with filter type 0)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"save_image takes uint8 [H,W,3], got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def save_image(path: str, img: np.ndarray):
    """Write a uint8 RGB image as PNG."""
    with open(path, "wb") as f:
        f.write(_png_bytes(img))


def write_video(out_path: str, frames: List[np.ndarray], pts_rate: float = 2.0) -> str:
    """An mp4 at 24/pts_rate fps through imageio (visualize.py:38); where
    imageio or its ffmpeg writer is missing, the frames as a uint8 [F,H,W,3]
    `.npy` stack beside it. Returns the path written."""
    fps = max(1.0, 24.0 / pts_rate)
    try:
        import imageio
        with imageio.get_writer(out_path, fps=fps, codec="libx264",
                                pixelformat="yuv420p", quality=8) as w:
            for frame in frames:
                w.append_data(frame)
        return out_path
    except Exception as e:                  # no imageio, or no ffmpeg for it
        path = os.path.splitext(out_path)[0] + ".npy"
        log.info("no mp4 writer (%s: %s); writing the frames to %s",
                 type(e).__name__, e, path)
        np.save(path, np.stack(frames).astype(np.uint8))
        return path


def write_gif(out_path: str, frames: List[np.ndarray], fps: int = 12) -> Optional[str]:
    """A GIF through imageio; None (logged) where imageio is not importable."""
    try:
        import imageio
    except ImportError:
        log.info("imageio is not installed; no GIF written for %s", out_path)
        return None
    imageio.mimsave(out_path, frames, fps=fps)
    return out_path


def visualize_depth(depth: np.ndarray, minmax=None) -> np.ndarray:
    """The JAX package colours depth with cv2's JET map; cv2 is not among
    the port's dependencies."""
    raise NotImplementedError("vis_depth needs cv2's colormap, which the port does "
                              "not carry; run without vis_depth")
