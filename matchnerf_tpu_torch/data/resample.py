"""PIL's `Image.resize(wh, LANCZOS | BILINEAR)` on uint8 arrays, bit-equal
to Pillow's `Resample.c`, without PIL (the port never imports it; it
need not be installed).

The resampling runs in the port's host library (`csrc/image_io.cpp`):
each output pixel's filter coefficients are computed in double,
normalised, then turned into fixed point with PRECISION_BITS = 32 - 8 - 2;
the horizontal pass runs first, over only the rows that the vertical pass
reads, then the vertical pass; each result is rounded and clipped to 8 bits.
LANCZOS has support 3 and BILINEAR support 1, each widened by the scale
when shrinking. Modes: L ([H,W]), RGB ([H,W,3]) and RGBA ([H,W,4]); RGBA
goes through premultiplied RGBa and back, as Pillow's `resize` converts it
(Convert.c `rgbA2rgba` / `rgba2rgbA`). A resize to the same size returns a
copy, as PIL's does.
"""
from __future__ import annotations

import numpy as np

from .. import hostio

FILTERS = {"lanczos": 1, "bilinear": 2}


def _premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA -> RGBa: each colour times alpha / 255 with MULDIV255's rounding."""
    out = img.copy()
    a = img[..., 3:].astype(np.uint32)
    tmp = img[..., :3].astype(np.uint32) * a + 128
    out[..., :3] = (((tmp >> 8) + tmp) >> 8).astype(np.uint8)
    return out


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA: each colour times 255 / alpha, truncated and clipped;
    alpha 0 and 255 leave the colours as they are."""
    out = img.copy()
    a = img[..., 3:].astype(np.int32)
    scaled = np.clip(255 * img[..., :3].astype(np.int32) // np.maximum(a, 1), 0, 255)
    keep = (a == 0) | (a == 255)
    out[..., :3] = np.where(keep, img[..., :3], scaled).astype(np.uint8)
    return out


def _resample(img: np.ndarray, wh, code: int) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ow, oh = (int(x) for x in wh)
    out = np.empty((oh, ow) + img.shape[2:], np.uint8)
    if hostio.library().resample_u8(img.ctypes.data, w, h, ch, out.ctypes.data,
                                    ow, oh, code) != 0:
        raise ValueError(f"resample: bad arguments (image {img.shape}, size {wh})")
    return out


def resize(img: np.ndarray, wh, resample: str = "lanczos") -> np.ndarray:
    """`np.asarray(Image.fromarray(img).resize(wh, filter))` for a uint8
    image of mode L ([H,W]), RGB or RGBA ([H,W,3|4]); wh = (width, height);
    resample is "lanczos" or "bilinear"."""
    if resample not in FILTERS:
        raise ValueError(f"resample {resample!r}: lanczos or bilinear")
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))):
        raise ValueError(f"resize takes uint8 [H,W], [H,W,3] or [H,W,4], not "
                         f"{img.dtype} {img.shape}")
    ow, oh = (int(x) for x in wh)
    if ow <= 0 or oh <= 0:
        raise ValueError(f"resize to {wh}: the size must be positive")
    if (ow, oh) == (img.shape[1], img.shape[0]):
        return img.copy()
    if img.ndim == 3 and img.shape[2] == 4:
        return _unpremultiply(_resample(_premultiply(img), (ow, oh), FILTERS[resample]))
    return _resample(img, (ow, oh), FILTERS[resample])
