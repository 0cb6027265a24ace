"""LPIPS (VGG) perceptual distance in PyTorch (counterpart of
matchnerf_tpu/lpips_jax.py).

The reference's metric, `lpips.LPIPS(net='vgg')`: the input scaled to
[-1, 1] and by the LPIPS scaling layer, VGG16's five pre-pool ReLU stages
(3x3 convolutions, padding 1; 2x2 max-pools between the stages), each
stage's features normalised to unit length over the channels (the eps
outside the square root), the squared difference weighted by the stage's
learned `lin{i}` vector, averaged over the pixels, and summed over the
stages.

The weights are read from `configs/lpips_vgg_weights.npz` (`_CACHE`), the
file the JAX package reads: convolutions `conv{i}_w` HWIO (transposed here
to OIHW) with `conv{i}_b`, and `lin{i}` [C]. The repository does not hold
that file and nothing here fetches it: without it `load_weights` raises
FileNotFoundError and `metrics.lpips_vgg` reports NaN. The convolutions run
with TF32 off on the card, so the distance is full f32.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "lpips_vgg_weights.npz")

# VGG16: (out_channels, convolutions) per stage, tapped after the last ReLU
_VGG_PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_state: Dict = {}


def load_weights(path: str = None) -> Dict[str, torch.Tensor]:
    """The npz's arrays as f32 CPU tensors, convolutions OIHW."""
    path = path or _CACHE
    if not os.path.isfile(path):
        raise FileNotFoundError(f"LPIPS VGG weights not found: {path}")
    out = {}
    with np.load(path) as z:
        for k in z.files:
            a = np.asarray(z[k], np.float32)
            if k.endswith("_w"):
                a = a.transpose(3, 2, 0, 1)
            out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def _weights(device: torch.device) -> Dict[str, torch.Tensor]:
    """The weights of `_CACHE` on `device`, loaded once per file and device."""
    key = (_CACHE, str(device))
    if _state.get("key") != key:
        _state["w"] = {k: v.to(device) for k, v in load_weights(_CACHE).items()}
        _state["key"] = key
    return _state["w"]


def vgg_features(w: Dict[str, torch.Tensor], x: torch.Tensor) -> List[torch.Tensor]:
    """x [N,3,H,W] (scaled input) -> the five stages' ReLU outputs."""
    feats = []
    ci = 0
    h = x
    for stage, (_, n) in enumerate(_VGG_PLAN):
        for _ in range(n):
            h = torch.clamp_min(F.conv2d(h, w[f"conv{ci}_w"], w[f"conv{ci}_b"], padding=1),
                                0.0)
            ci += 1
        feats.append(h)
        if stage < len(_VGG_PLAN) - 1:
            h = F.max_pool2d(h, 2, 2)
    return feats


@torch.no_grad()
def lpips_distance(pred: np.ndarray, gt: np.ndarray, device) -> float:
    """pred / gt [H,W,3] in [0,1] -> the LPIPS(VGG) distance, computed on
    `device` ("cuda", "cpu" or a torch.device; there is no default)."""
    if device is None:
        raise TypeError("lpips_distance needs a device: the card ('cuda') or 'cpu'")
    device = torch.device(device)
    w = _weights(device)
    shift = torch.from_numpy(_SHIFT).to(device)[None, :, None, None]
    scale = torch.from_numpy(_SCALE).to(device)[None, :, None, None]
    x = torch.stack([torch.as_tensor(np.asarray(a, np.float32)) for a in (pred, gt)])
    x = x.to(device).permute(0, 3, 1, 2)
    x = (x * 2.0 - 1.0 - shift) / scale
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        feats = vgg_features(w, x)
    total = torch.zeros((), dtype=torch.float32, device=device)
    for i, f in enumerate(feats):
        # lpips.normalize_tensor: the eps outside the square root
        n = f / (torch.sqrt((f ** 2).sum(1, keepdim=True)) + 1e-10)
        diff = (n[0] - n[1]) ** 2                                    # [C,h,w]
        total = total + (diff * w[f"lin{i}"][:, None, None]).sum(0).mean()
    return float(total)
