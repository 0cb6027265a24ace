"""Positional encodings (counterpart of matchnerf_tpu/ops/posenc.py)."""
from __future__ import annotations

import math

import numpy as np
import torch


def sine_position_embedding_2d(h: int, w: int, num_pos_feats: int = 64,
                               temperature: float = 10000.0,
                               scale: float = 2 * math.pi,
                               device=None) -> torch.Tensor:
    """[h, w, 2*num_pos_feats] DETR sine embedding (posenc.py:18); computed
    in numpy exactly as the JAX package does, then moved to `device`."""
    y_embed = np.cumsum(np.ones((h, w), np.float32), axis=0)
    x_embed = np.cumsum(np.ones((h, w), np.float32), axis=1)
    eps = 1e-6
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * np.trunc(dim_t / 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos = np.concatenate([pos_y, pos_x], axis=2).astype(np.float32)
    return torch.from_numpy(pos).to(device)


def nerf_posenc(x: torch.Tensor, L: int) -> torch.Tensor:
    """Standard NeRF encoding, pi-scaled and interleaved (posenc.py:37)."""
    freq = (2.0 ** torch.arange(L, dtype=torch.float32, device=x.device)) * math.pi
    spectrum = x[..., None] * freq                                  # [...,N,L]
    enc = torch.stack([torch.sin(spectrum), torch.cos(spectrum)], dim=-2)
    return enc.reshape(*x.shape[:-1], -1)


def nerf_posenc_legacy(x: torch.Tensor, L: int) -> torch.Tensor:
    """Legacy encoding: no pi, frequency-major, all sins then all cosines
    (posenc.py:47). x: [...,N] -> [...,2NL]."""
    freq = 2.0 ** torch.arange(L, dtype=torch.float32, device=x.device)
    spectrum = (x[..., None, :] * freq[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([torch.sin(spectrum), torch.cos(spectrum)], dim=-1)


def ray_sinusoid_table(d_hid: int, n_samples: int, device=None) -> torch.Tensor:
    """[1, n_samples, d_hid] ray-transformer position table (posenc.py:57)."""
    pos = np.arange(n_samples)[:, None]
    hid = np.arange(d_hid)[None, :]
    table = pos / np.power(10000, 2 * (hid // 2) / d_hid)
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return torch.from_numpy(table[None].astype(np.float32)).to(device)
