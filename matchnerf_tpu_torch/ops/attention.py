"""Swin-style split-window attention around Kernel A
(counterpart of matchnerf_tpu/ops/attention.py).

Features stay [B,H,W,C] at this module's boundary, as in the JAX package.
`split_window_attention` does the cyclic roll and the window split in torch,
then hands the [B*K*K, L, C] windows to `ops.window_attention` (the CUDA
kernel on the card, its plain version on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from .window_attention import window_attention, window_attention_plain


def split_feature(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """[B,H,W,C] -> [B*K*K, H/K, W/K, C], row-major over (row, col) blocks."""
    b, h, w, c = x.shape
    assert h % num_splits == 0 and w % num_splits == 0
    hs, ws = h // num_splits, w // num_splits
    x = x.reshape(b, num_splits, hs, num_splits, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * num_splits * num_splits, hs, ws, c)


def merge_splits(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """Inverse of `split_feature`."""
    bkk, hs, ws, c = x.shape
    b = bkk // (num_splits * num_splits)
    x = x.reshape(b, num_splits, num_splits, hs, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, num_splits * hs, num_splits * ws, c)


def window_region_ids(h: int, w: int, window_size_h: int, window_size_w: int,
                      shift_size_h: int, shift_size_w: int) -> np.ndarray:
    """Per-token region ids [K*K, win] of the shifted windows
    (attention.py:38): tokens of different regions in one rolled window may
    not attend to each other."""
    img_mask = np.zeros((h, w), np.float32)
    h_slices = (slice(0, -window_size_h), slice(-window_size_h, -shift_size_h),
                slice(-shift_size_h, None))
    w_slices = (slice(0, -window_size_w), slice(-window_size_w, -shift_size_w),
                slice(-shift_size_w, None))
    cnt = 0
    for hs in h_slices:
        for ws in w_slices:
            img_mask[hs, ws] = cnt
            cnt += 1
    num_splits = w // window_size_w
    m = img_mask.reshape(1, num_splits, window_size_h, num_splits, window_size_w, 1)
    return m.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window_size_h * window_size_w)


def generate_shift_window_attn_mask(h: int, w: int, window_size_h: int,
                                    window_size_w: int, shift_size_h: int,
                                    shift_size_w: int) -> torch.Tensor:
    """Additive [K*K, win, win] mask, -100 across regions (attention.py:61)."""
    m = window_region_ids(h, w, window_size_h, window_size_w,
                          shift_size_h, shift_size_w)
    diff = m[:, None, :] - m[:, :, None]
    return torch.from_numpy(np.where(diff != 0, -100.0, 0.0).astype(np.float32))


def shift_region_ids(h: int, w: int, num_splits: int, device=None) -> torch.Tensor:
    """int32 [K*K, L] region ids for a [h,w] map split into K x K windows
    shifted by half a window: the mask input of Kernel A."""
    ws_h, ws_w = h // num_splits, w // num_splits
    m = window_region_ids(h, w, ws_h, ws_w, ws_h // 2, ws_w // 2)
    return torch.from_numpy(m.astype(np.int32)).to(device)


def split_window_attention(q, k, v, num_splits: int, with_shift: bool,
                           region_ids=None, kernel: bool = True):
    """Window attention over [B,H,W,C] maps (attention.py:86).

    Rolls by half a window when `with_shift`, splits into K^2 windows, runs
    attention per window with the -100 region mask on shifted layers, merges
    and rolls back. `region_ids` [K*K, L] int32 is `shift_region_ids`;
    `kernel=False` calls the plain window attention even for CUDA tensors
    (the all-plain reference render)."""
    b, h, w, c = q.shape
    ws_h, ws_w = h // num_splits, w // num_splits
    b_new = b * num_splits * num_splits
    if with_shift:
        assert region_ids is not None
        sh, sw = ws_h // 2, ws_w // 2
        q, k, v = (torch.roll(t, shifts=(-sh, -sw), dims=(1, 2)) for t in (q, k, v))
    qs, ks, vs = (split_feature(t, num_splits).reshape(b_new, -1, c).contiguous()
                  for t in (q, k, v))
    rid = region_ids if with_shift else None
    attn = window_attention if kernel else window_attention_plain
    out = attn(qs, ks, vs, rid)
    out = merge_splits(out.reshape(b_new, ws_h, ws_w, c), num_splits)
    if with_shift:
        out = torch.roll(out, shifts=(sh, sw), dims=(1, 2))
    return out
