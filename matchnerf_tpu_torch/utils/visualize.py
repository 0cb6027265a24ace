"""Image and video output (counterpart of matchnerf_tpu/utils/visualize.py)
that needs no imaging package: PNG through `data/png.py` (numpy and zlib);
mp4 and GIF through imageio only where it is importable, and otherwise the
frames as one uint8 `.npy` stack; the depth colour map as a table equal to
cv2's JET.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np

from ..data.png import write_png

log = logging.getLogger(__name__)


def save_image(path: str, img: np.ndarray):
    """Write a uint8 RGB image [H,W,3] as PNG (whatever the extension)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"save_image takes uint8 [H,W,3], got {img.dtype} {img.shape}")
    write_png(path, img, ftype=0)


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


def jet_colormap() -> np.ndarray:
    """cv2's COLORMAP_JET as a [256, 3] uint8 RGB table: piecewise linear,
    4 levels per index, with cv2's rounding of entry 159's blue."""
    i = np.arange(256)
    lut = np.stack([np.minimum(4 * i - 382, 1148 - 4 * i),
                    np.minimum(4 * i - 128, 892 - 4 * i),
                    np.minimum(4 * i + 128, 638 - 4 * i)], axis=1)
    lut = np.clip(lut, 0, 255).astype(np.uint8)
    lut[159, 2] = 1
    return lut


def visualize_depth(depth: np.ndarray, minmax=None) -> np.ndarray:
    """depth [H,W] -> JET-coloured uint8 [H,W,3] (visualize.py:17): scaled
    to [0, 1] by minmax (default: the smallest positive and the largest
    depth), then cv2's JET table."""
    x = np.nan_to_num(np.asarray(depth))
    if minmax is None:
        positive = x[x > 0]
        mi = np.min(positive) if positive.size else 0.0
        ma = np.max(x)
    else:
        mi, ma = minmax
    x = (x - mi) / (ma - mi + 1e-8)
    return jet_colormap()[(255 * np.clip(x, 0, 1)).astype(np.uint8)]
