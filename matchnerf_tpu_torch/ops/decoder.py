"""Kernel C: the CondNeRF decoder with the composite folded in.

Replaces matchnerf_tpu/ops/pallas_decoder.py::cond_nerf_decode with
fold_composite=True (the eval path's decoder megakernel), on both of its
operand routes. The CUDA source is csrc/cond_nerf_decode.cu;
`cond_nerf_decode_plain` is the same function in plain PyTorch
(`apply_cond_nerf` with the route's operand type, then `composite`).

Per ray: legacy posenc (L=10) of the view-0 NDC point; 6 width-128 layers
relu((W h + b) * pts_bias(cond)) with the skip concat after layer 4; the
16-d alpha token; the 4-head ray transformer over the S samples (query-axis
mask fill where fewer than 2 views see the point, LayerNorm eps 1e-6); the
density head (optional maskfill) and the sigmoid rgb head; then the
emission-absorption composite. Returns rgb [B,R,3], depth [B,R,1],
opacity [B,R,1].

Routes (`matmul_dtype`, from precision.decoder_matmul_dtype): float32, the
default, is f32 throughout (the kernel takes its wide products in split
TF32); bfloat16 rounds the operands of the wide products (pts_bias, the
pts_linears, alpha_linear, feature_linear, views_linears.0, rgb_linear) to
bf16 and accumulates in f32, as the JAX kernel's matmul_dtype=bfloat16 does;
everything else stays f32. The kernel takes 1 <= S <= S_MAX samples per ray.
"""
from __future__ import annotations

import weakref

import torch

from .. import kernels
from ..models.decoder.cond_nerf import (CondNeRF, apply_cond_nerf, composite,
                                        raytrans_act_name)
from ..utils.containers import effective_precision
from .posenc import ray_sinusoid_table

COUNTER = kernels.LaunchCounter(
    "cond_nerf_decode", source="matchnerf_tpu_torch/csrc/cond_nerf_decode.cu",
    replaces="matchnerf_tpu/ops/pallas_decoder.py:59")
_ACT_IDS = {"ReLU": 0, "ELU": 1}
S_MAX = 512                       # the kernel's shared-memory plan (csrc S_MAX)
ROUTES = {torch.float32: "cond_nerf_decode_f32", torch.bfloat16: "cond_nerf_decode_bf16"}


def decoder_matmul_dtype(cfg) -> torch.dtype:
    """precision.decoder_matmul_dtype (after `strict`): bf16 or float32."""
    prec = effective_precision(cfg)
    name = prec.get("decoder_matmul_dtype") if hasattr(prec, "get") else None
    return torch.bfloat16 if str(name) in ("bf16", "bfloat16") else torch.float32


def cond_nerf_decode_plain(dec: CondNeRF, cfg, points_3d, ray_unit, cond_info,
                           depth_samples, ray, setbg_opaque: bool = False,
                           matmul_dtype: torch.dtype = torch.float32):
    if points_3d.is_cuda:
        COUNTER.plain_on_cuda += 1
    rgb_s, den_s = apply_cond_nerf(dec, cfg, points_3d, ray_unit, cond_info,
                                   matmul_dtype=matmul_dtype)
    rgb, depth, opacity, _ = composite(cfg, ray, rgb_s, den_s, depth_samples,
                                       setbg_opaque=setbg_opaque)
    return rgb, depth, opacity


# ---- parameter packing ----------------------------------------------------

def pack_small(dec: CondNeRF) -> torch.Tensor:
    """The biases and the 16-wide layers as one f32 vector, in the order of
    the SM_* offsets of the .cu file: wide-layer biases (pts_bias, the six
    pts_linears, feature_linear, views_linears.0, alpha_linear, rgb_linear
    padded to 16), then w_qs, w_ks, w_vs, fc as [in, out], the LayerNorm
    weight and bias, out_alpha_linear.0 as [in, out] and its bias,
    out_alpha_linear.2's weight and bias."""
    ra = dec.ray_attention
    rgb_b = torch.zeros(16, dtype=torch.float32, device=dec.rgb_linear.bias.device)
    rgb_b[:3] = dec.rgb_linear.bias.detach().float()
    parts = ([dec.pts_bias.bias] + [m.bias for m in dec.pts_linears]
             + [dec.feature_linear.bias, dec.views_linears[0].bias,
                dec.alpha_linear[0].bias, rgb_b]
             + [m.weight.t() for m in (ra.w_qs, ra.w_ks, ra.w_vs, ra.fc)]
             + [ra.layer_norm.weight, ra.layer_norm.bias,
                dec.out_alpha_linear[0].weight.t(), dec.out_alpha_linear[0].bias,
                dec.out_alpha_linear[2].weight, dec.out_alpha_linear[2].bias])
    return torch.cat([p.detach().float().reshape(-1) for p in parts]).contiguous()


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def wide_layers(dec: CondNeRF):
    """The wide layers in the kernel's stream order, each as its padded
    [K, N] f32 matrix (input rows, output columns): K rounded up to 16 with
    zero rows (the encoding 63 -> 64, so the skip layer's h rows start at
    64; the views input 131 -> 144), rgb_linear's 3 outputs padded to 16."""
    def padded(w_in_out, k, n, rows=None):
        out = torch.zeros(k, n, dtype=torch.float32, device=w_in_out.device)
        src = w_in_out.detach().float()
        if rows is None:
            out[:src.shape[0], :src.shape[1]] = src
        else:
            for dst0, src0, cnt in rows:
                out[dst0:dst0 + cnt, :src.shape[1]] = src[src0:src0 + cnt]
        return out

    cd = dec.pts_bias.in_features
    mats = [padded(dec.pts_bias.weight.t(), _ceil16(cd), 128)]
    for i, m in enumerate(dec.pts_linears):
        w = m.weight.t()
        if i == 0:
            mats.append(padded(w, 64, 128))
        elif w.shape[0] == 63 + 128:            # the skip layer: [enc, h]
            mats.append(padded(w, 192, 128, rows=[(0, 0, 63), (64, 63, 128)]))
        else:
            mats.append(padded(w, 128, 128))
    mats.append(padded(dec.alpha_linear[0].weight.t(), 128, 16))
    mats.append(padded(dec.feature_linear.weight.t(), 128, 128))
    mats.append(padded(dec.views_linears[0].weight.t(), 144, 64))
    mats.append(padded(dec.rgb_linear.weight.t(), 64, 16))
    return mats


def split_tf32(w: torch.Tensor):
    """(hi, lo) with hi = w rounded to TF32 (nearest, ties away from zero,
    as cvt.rna.tf32.f32) and lo = w - hi exactly, so hi + lo == w."""
    bits = w.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, w - hi


def fragments(w: torch.Tensor, matmul_dtype: torch.dtype) -> torch.Tensor:
    """One padded [K, N] layer in the B-fragment order of its route, as
    bytes. float32 (split TF32, mma m16n8k8): per (k8 step j, n8 tile, lane
    4g + t) the 16 bytes hi(W[8j+2t, n]), hi(W[8j+2t+1, n]), lo(..), lo(..)
    with n = 8 tile + g (the K rows of each k8 step permuted so that the
    accumulator layout is the next A layout). bfloat16 (mma m16n8k16): per
    (k16 step, n16 pair, lane) the 8 values W[16kb + 8r + 2t + i, 16p + 8u +
    g] in the order (u, r, i)."""
    K, N = w.shape
    if matmul_dtype == torch.float32:
        hi, lo = split_tf32(w)
        parts = [x.reshape(K // 8, 4, 2, N // 8, 8).permute(0, 3, 4, 1, 2)
                 .reshape(K // 8, N // 8, 32, 2) for x in (hi, lo)]
        return torch.cat(parts, dim=-1).contiguous().view(torch.uint8).reshape(-1)
    if matmul_dtype == torch.bfloat16:
        b = w.to(torch.bfloat16).reshape(K // 16, 2, 4, 2, N // 16, 2, 8)
        b = b.permute(0, 4, 6, 2, 5, 1, 3).reshape(K // 16, N // 16, 32, 8)
        return b.contiguous().view(torch.uint8).reshape(-1)
    raise ValueError(f"cond_nerf_decode: matmul_dtype {matmul_dtype}")


def pack_fragments(dec: CondNeRF, matmul_dtype: torch.dtype) -> torch.Tensor:
    """Every wide layer in stream order, in its route's fragment order (uint8)."""
    return torch.cat([fragments(w, matmul_dtype) for w in wide_layers(dec)])


_PACKED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_POSTAB: dict = {}


def _stamp(dec: CondNeRF):
    return tuple((p.data_ptr(), p._version) for p in dec.parameters())


def kernel_weights(dec: CondNeRF, matmul_dtype: torch.dtype, device):
    """(small, fragments) of the route on `device`, packed once per module,
    route and device and packed again when a parameter changes: an in-place
    update (optimizer step, load_state_dict) bumps its version, a move or
    replacement its storage. A write through `.data` is not seen."""
    per = _PACKED.setdefault(dec, {})
    key = (matmul_dtype, str(torch.device(device)))
    stamp = _stamp(dec)
    hit = per.get(key)
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = (stamp, pack_small(dec).to(device),
                   pack_fragments(dec, matmul_dtype).to(device))
        per[key] = hit
    return hit[1], hit[2]


def postab_table(S: int, device) -> torch.Tensor:
    """The ray transformer's [S, 16] sinusoid table on `device`, cached."""
    key = (S, str(torch.device(device)))
    if key not in _POSTAB:
        _POSTAB[key] = ray_sinusoid_table(16, S, device=device)[0].contiguous()
    return _POSTAB[key]


def _check_supported(dec: CondNeRF, cfg, S: int):
    posenc = cfg.decoder.posenc
    problems = []
    if int(cfg.decoder.net_width) != 128 or len(dec.pts_linears) != 6:
        problems.append("net_width 128 and net_depth 6")
    if sorted(set(cfg.decoder.skip)) != [4]:
        problems.append("skip [4]")
    if not posenc or int(posenc.L_3D) != 10 or int(posenc.L_view) != 0:
        problems.append("posenc L_3D 10, L_view 0")
    if not cfg.nerf.legacy_coord:
        problems.append("legacy_coord")
    if raytrans_act_name(cfg) not in _ACT_IDS:
        problems.append("raytrans_act ReLU or ELU")
    if not 1 <= S <= S_MAX:
        problems.append(f"1 <= S <= {S_MAX} samples per ray (S = {S})")
    if problems:
        raise ValueError("cond_nerf_decode: the kernel takes " + ", ".join(problems))


def cond_nerf_decode(dec: CondNeRF, cfg, points_3d, ray_unit, cond_info,
                     depth_samples, ray, setbg_opaque: bool = False,
                     matmul_dtype: torch.dtype = torch.float32):
    """The kernel on CUDA tensors, the plain version on CPU tensors.

    points_3d, ray_unit: [B,R,S,3]; cond_info: feat_info [B,R,S,Gf],
    color_info [B,R,S,3V], mask_info [B,R,S,V]; depth_samples [B,R,S,1];
    ray [B,R,3] unnormalised. All f32 and contiguous. matmul_dtype picks the
    route (torch.float32 or torch.bfloat16)."""
    if points_3d.device.type == "cpu":
        return cond_nerf_decode_plain(dec, cfg, points_3d, ray_unit, cond_info,
                                      depth_samples, ray, setbg_opaque, matmul_dtype)
    if not points_3d.is_cuda:
        raise ValueError(f"cond_nerf_decode: unsupported device {points_3d.device}")
    if matmul_dtype not in ROUTES:
        raise ValueError(f"cond_nerf_decode: matmul_dtype {matmul_dtype}, the kernel "
                         f"takes {list(ROUTES)}")
    B, R, S, _ = points_3d.shape
    _check_supported(dec, cfg, S)
    V = int(cfg.n_src_views)
    feat, color, mask = (cond_info["feat_info"], cond_info["color_info"],
                         cond_info["mask_info"])
    Gf = feat.shape[-1]
    expect = {"points_3d": (points_3d, (B, R, S, 3)),
              "ray_unit": (ray_unit, (B, R, S, 3)),
              "feat_info": (feat, (B, R, S, Gf)),
              "color_info": (color, (B, R, S, 3 * V)),
              "mask_info": (mask, (B, R, S, V)),
              "depth_samples": (depth_samples, (B, R, S, 1)),
              "ray": (ray, (B, R, 3))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"cond_nerf_decode: {name} {tuple(t.shape)} {t.dtype}, "
                             f"kernel takes f32 {shape}")
        if t.device != points_3d.device or not t.is_contiguous():
            raise ValueError(f"cond_nerf_decode: {name} must be contiguous on "
                             f"{points_3d.device}")
    if Gf + 4 * V != dec.pts_bias.in_features or Gf + 4 * V > 64:
        raise ValueError(f"cond_nerf_decode: conditioning width {Gf + 4 * V}")
    small, frag = kernel_weights(dec, matmul_dtype, points_3d.device)
    postab = postab_table(S, points_3d.device) if cfg.decoder.raytrans_posenc else None
    N = B * R
    out = torch.empty(N, 5, dtype=torch.float32, device=points_3d.device)
    kernels.launch(
        COUNTER, ROUTES[matmul_dtype], points_3d.data_ptr(), ray_unit.data_ptr(),
        feat.data_ptr(), color.data_ptr(), mask.data_ptr(), depth_samples.data_ptr(),
        ray.data_ptr(), small.data_ptr(), frag.data_ptr(), kernels.ptr(postab),
        out.data_ptr(), frag.numel() // 16, N, S, Gf, V,
        _ACT_IDS[raytrans_act_name(cfg)], int(bool(cfg.decoder.density_maskfill)),
        int(bool(cfg.nerf.wo_render_interval)), int(bool(setbg_opaque)),
        variant="setbg" if setbg_opaque else "")
    out = out.reshape(B, R, 5)
    return out[..., 0:3], out[..., 3:4], out[..., 4:5]
