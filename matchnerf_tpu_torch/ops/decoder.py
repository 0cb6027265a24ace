"""Kernels C and Cg: the CondNeRF decoder with the composite folded in.

Replace matchnerf_tpu/ops/pallas_decoder.py::cond_nerf_decode with
fold_composite=True (the eval path's decoder megakernel), on both of its
operand routes. Kernel C (csrc/cond_nerf_decode.cu) takes the shipped
decoder; Kernel Cg (csrc/cond_nerf_decode_any.cu) every other view-dependent
decoder the TPU kernel takes (`decoder_route` picks one, or raises).
`cond_nerf_decode_plain` is the function of both in plain PyTorch
(`apply_cond_nerf` with the route's operand type, then `composite`).

Per ray: the posenc of the view-0 NDC point; the layers
relu((W h + b) * pts_bias(cond)) with the skip concat [enc, h] after each
layer in `skip`; the 16-d alpha token; the 4-head ray transformer over the S
samples (query-axis mask fill where fewer than 2 views see the point,
LayerNorm eps 1e-6); the density head (optional maskfill) and the sigmoid
rgb head over [feature, direction encoding]; then the emission-absorption
composite. Returns rgb [B,R,3], depth [B,R,1], opacity [B,R,1].

Kernel C: width 128, depth 6, skip [4], L_3D 10, L_view 0, legacy
coordinates, raytrans_act ReLU or ELU, Gf + 4V <= 64. Kernel Cg
(`CG_LIMITS`): an even net_width from 32 to 512, net_depth 1 to 16, any skip
set but the last layer, L_3D and L_view 0 to 10, legacy or standard
coordinates, ReLU, ELU or GELU (tanh form), Gf + 4V <= 128. Both take
1 <= S <= S_MAX samples per ray.

Routes (`matmul_dtype`, from precision.decoder_matmul_dtype): float32, the
default, is f32 throughout (Kernel C takes its wide products in split TF32,
Kernel Cg in f32 on the CUDA cores); bfloat16 rounds the operands of the
wide products (pts_bias, the pts_linears, alpha_linear, feature_linear,
views_linears.0, rgb_linear) to bf16 and accumulates in f32, as the JAX
kernel's matmul_dtype=bfloat16 does; everything else stays f32.
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
COUNTER_ANY = kernels.LaunchCounter(
    "cond_nerf_decode_any", source="matchnerf_tpu_torch/csrc/cond_nerf_decode_any.cu",
    replaces="matchnerf_tpu/ops/pallas_decoder.py:59")
_ACT_IDS = {"ReLU": 0, "ELU": 1, "GELU": 2}    # Kernel C takes the first two
S_MAX = 512                       # the kernels' shared-memory plans (csrc S_MAX)
C_CD_MAX = 64                     # Kernel C's conditioning width (csrc CD_MAX)
ROUTES = {torch.float32: "cond_nerf_decode_f32", torch.bfloat16: "cond_nerf_decode_bf16"}
ROUTES_ANY = {torch.float32: "cond_nerf_decode_any_f32",
              torch.bfloat16: "cond_nerf_decode_any_bf16"}
# Kernel Cg's limits (csrc/cond_nerf_decode_any.cu W_MIN .. CD_MAX)
CG_LIMITS = {"net_width": (32, 512), "net_depth": (1, 16), "L": (0, 10), "cond": 128}


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
        COUNTER_ANY.plain_on_cuda += 1
    rgb_s, den_s = apply_cond_nerf(dec, cfg, points_3d, ray_unit, cond_info,
                                   matmul_dtype=matmul_dtype)
    rgb, depth, opacity, _ = composite(cfg, ray, rgb_s, den_s, depth_samples,
                                       setbg_opaque=setbg_opaque)
    return rgb, depth, opacity


# ---- parameter packing ----------------------------------------------------

def _tail(dec: CondNeRF):
    """The ray tail's 16-wide parameters, in the order of both kernels:
    w_qs, w_ks, w_vs, fc as [in, out], the LayerNorm weight and bias,
    out_alpha_linear.0 as [in, out] and its bias, out_alpha_linear.2's
    weight and bias (1345 floats)."""
    ra = dec.ray_attention
    return ([m.weight.t() for m in (ra.w_qs, ra.w_ks, ra.w_vs, ra.fc)]
            + [ra.layer_norm.weight, ra.layer_norm.bias,
               dec.out_alpha_linear[0].weight.t(), dec.out_alpha_linear[0].bias,
               dec.out_alpha_linear[2].weight, dec.out_alpha_linear[2].bias])


def pack_small(dec: CondNeRF) -> torch.Tensor:
    """Kernel C's biases and 16-wide layers as one f32 vector, in the order
    of the SM_* offsets of the .cu file: wide-layer biases (pts_bias, the six
    pts_linears, feature_linear, views_linears.0, alpha_linear, rgb_linear
    padded to 16), then `_tail`."""
    rgb_b = torch.zeros(16, dtype=torch.float32, device=dec.rgb_linear.bias.device)
    rgb_b[:3] = dec.rgb_linear.bias.detach().float()
    parts = ([dec.pts_bias.bias] + [m.bias for m in dec.pts_linears]
             + [dec.feature_linear.bias, dec.views_linears[0].bias,
                dec.alpha_linear[0].bias, rgb_b] + _tail(dec))
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


def kernel_weights(dec: CondNeRF, matmul_dtype: torch.dtype, device, kernel: str = "C"):
    """Kernel C's (small, fragments) or, with kernel "Cg", Kernel Cg's
    (small, weights) of the route on `device`, packed once per module,
    kernel, route and device and packed again when a parameter changes: an
    in-place update (optimizer step, load_state_dict) bumps its version, a
    move or replacement its storage. A write through `.data` is not seen."""
    per = _PACKED.setdefault(dec, {})
    key = (kernel, matmul_dtype, str(torch.device(device)))
    stamp = _stamp(dec)
    hit = per.get(key)
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            if kernel == "C":
                packed = pack_small(dec), pack_fragments(dec, matmul_dtype)
            else:
                packed = pack_any(dec, matmul_dtype)
            hit = (stamp, *(t.to(device) for t in packed))
        per[key] = hit
    return hit[1], hit[2]


def postab_table(S: int, device) -> torch.Tensor:
    """The ray transformer's [S, 16] sinusoid table on `device`, cached."""
    key = (S, str(torch.device(device)))
    if key not in _POSTAB:
        _POSTAB[key] = ray_sinusoid_table(16, S, device=device)[0].contiguous()
    return _POSTAB[key]


def _check_supported(dec: CondNeRF, cfg, S: int):
    """Raises unless Kernel C takes the decoder (its conditioning width
    aside: `decoder_route` checks that)."""
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
    if raytrans_act_name(cfg) not in ("ReLU", "ELU"):
        problems.append("raytrans_act ReLU or ELU")
    if not 1 <= S <= S_MAX:
        problems.append(f"1 <= S <= {S_MAX} samples per ray (S = {S})")
    if problems:
        raise ValueError("cond_nerf_decode: the kernel takes " + ", ".join(problems))


# ---- Kernel Cg: any decoder shape ------------------------------------------

SM_BIAS = 1348                    # the biases' offset in Cg's small buffer (csrc)


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def decoder_shape(dec: CondNeRF):
    """(W, D, skip layers, E, Ev, CD) of a view-dependent CondNeRF, read from
    its layers: width, depth, the pts_linears that read [enc, h] (layer l
    follows a skip at l - 1), the point and direction encoding widths and
    the conditioning width."""
    W = dec.pts_linears[0].out_features
    E = dec.pts_linears[0].in_features
    skips = tuple(l for l, m in enumerate(dec.pts_linears) if l and m.in_features == W + E)
    return (W, len(dec.pts_linears), skips, E, dec.views_linears[0].in_features - W,
            dec.pts_bias.in_features)


def any_plan(W: int, D: int, skips, E: int, Ev: int, CD: int):
    """Kernel Cg's parameter layout (csrc make_plan) -> (layers, n_wts,
    n_small). Each wide layer, in stream order, is a row-major [K, np] f32
    block of the weight buffer at `woff`: its input parts one after the
    other, each padded to a multiple of 8 rows with zeros (`parts`: (input,
    padded rows, real rows)), its outputs padded with zero columns to `np`;
    its bias sits at `boff` of the small buffer, after `_tail`'s 1345
    floats (padded to SM_BIAS). The layers: pts_bias (the conditioning),
    pts_linears 0 .. D-1 (layer 0 the encoding; a layer in `skips` the
    encoding then h; else h), alpha_linear.0 (16 outputs), feature_linear,
    views_linears.0 (h = the feature, then the direction encoding; W/2
    outputs), rgb_linear (8 outputs, 3 used)."""
    W8, H8, E8, Ev8, CD8 = (_ceil8(x) for x in (W, W // 2, E, Ev, CD))
    layers, woff, boff = [], 0, SM_BIAS

    def add(name, parts, np_):
        nonlocal woff, boff
        layers.append({"name": name, "parts": parts, "np": np_, "woff": woff, "boff": boff})
        woff += sum(p[1] for p in parts) * np_
        boff += np_
    add("pts_bias", [("cond", CD8, CD)], W8)
    for l in range(D):
        parts = ([("enc", E8, E)] if l == 0 else
                 [("enc", E8, E), ("h", W8, W)] if l in skips else [("h", W8, W)])
        add(f"pts_linears.{l}", parts, W8)
    add("alpha_linear.0", [("h", W8, W)], 16)
    add("feature_linear", [("h", W8, W)], W8)
    add("views_linears.0", [("h", W8, W), ("dir", Ev8, Ev)], H8)
    add("rgb_linear", [("h", H8, W // 2)], 8)
    return layers, woff, boff


def pack_any(dec: CondNeRF, matmul_dtype: torch.dtype):
    """(small, weights) of Kernel Cg in the layout of `any_plan`, f32; on
    the bfloat16 route the weights hold bf16 values (the biases and the
    16-wide layers stay f32)."""
    if matmul_dtype not in ROUTES_ANY:
        raise ValueError(f"cond_nerf_decode: matmul_dtype {matmul_dtype}")
    layers, n_wts, n_small = any_plan(*decoder_shape(dec))
    mods = dict(dec.named_modules())
    dev = dec.pts_bias.weight.device
    small = torch.zeros(n_small, dtype=torch.float32, device=dev)
    tail = torch.cat([p.detach().float().reshape(-1) for p in _tail(dec)])
    small[:tail.numel()] = tail
    wts = torch.zeros(n_wts, dtype=torch.float32, device=dev)
    for lay in layers:
        m = mods[lay["name"]]
        w = m.weight.detach().float().t()                         # [in, out]
        if matmul_dtype == torch.bfloat16:
            w = w.to(torch.bfloat16).float()
        K, n_out = sum(p[1] for p in lay["parts"]), w.shape[1]
        block = torch.zeros(K, lay["np"], dtype=torch.float32, device=dev)
        src = dst = 0
        for _, padded, real in lay["parts"]:
            block[dst:dst + real, :n_out] = w[src:src + real]
            src, dst = src + real, dst + padded
        wts[lay["woff"]:lay["woff"] + block.numel()] = block.reshape(-1)
        small[lay["boff"]:lay["boff"] + n_out] = m.bias.detach().float()
    return small, wts


def _posenc_freqs(cfg):
    posenc = cfg.decoder.posenc
    return (int(posenc.L_3D), int(posenc.L_view)) if posenc else (0, 0)


def _cg_problems(dec: CondNeRF, cfg, S: int):
    """What of the decoder lies beyond Kernel Cg's limits (CG_LIMITS)."""
    W, D, _, E, Ev, CD = decoder_shape(dec)
    L3, Lv = _posenc_freqs(cfg)
    (w0, w1), (d0, d1), (l0, l1) = (CG_LIMITS[k] for k in ("net_width", "net_depth", "L"))
    problems = []
    if not (w0 <= W <= w1 and W % 2 == 0):
        problems.append(f"an even net_width from {w0} to {w1} (net_width {W})")
    if not d0 <= D <= d1:
        problems.append(f"net_depth {d0} to {d1} (net_depth {D})")
    if D - 1 in set(cfg.decoder.skip):
        problems.append(f"no skip after the last layer (skip {list(cfg.decoder.skip)}, "
                        f"net_depth {D})")
    if not (l0 <= L3 <= l1 and l0 <= Lv <= l1):
        problems.append(f"posenc L_3D and L_view {l0} to {l1} (L_3D {L3}, L_view {Lv})")
    elif E != 3 + 6 * L3 or Ev != 3 + 6 * Lv:
        problems.append(f"layers of the config's posenc (inputs {E} and {Ev})")
    if raytrans_act_name(cfg) not in _ACT_IDS:
        problems.append(f"raytrans_act ReLU, ELU or GELU ({raytrans_act_name(cfg)})")
    if CD > CG_LIMITS["cond"]:
        problems.append(f"Gf + 4V <= {CG_LIMITS['cond']} (Gf + 4V = {CD})")
    if not 1 <= S <= S_MAX:
        problems.append(f"1 <= S <= {S_MAX} samples per ray (S = {S})")
    return problems


def decoder_route(dec: CondNeRF, cfg, S: int) -> str:
    """"C" (Kernel C) for the shipped decoder, "Cg" (Kernel Cg) for every
    other view-dependent decoder within CG_LIMITS; raises a ValueError that
    names the limit for anything else."""
    if not cfg.nerf.view_dep:
        raise ValueError("cond_nerf_decode: the decoder without view dependence "
                         "(nerf.view_dep: false) has no kernel")
    try:
        _check_supported(dec, cfg, S)
        if dec.pts_bias.in_features <= C_CD_MAX:
            return "C"
    except ValueError:
        pass
    problems = _cg_problems(dec, cfg, S)
    if problems:
        raise ValueError("cond_nerf_decode: no kernel takes this decoder; Kernel Cg takes "
                         + "; ".join(problems))
    return "Cg"


def cond_nerf_decode(dec: CondNeRF, cfg, points_3d, ray_unit, cond_info,
                     depth_samples, ray, setbg_opaque: bool = False,
                     matmul_dtype: torch.dtype = torch.float32):
    """Kernel C or Cg (`decoder_route`) on CUDA tensors, the plain version on
    CPU tensors.

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
    kernel = decoder_route(dec, cfg, S)
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
    if Gf + 4 * V != dec.pts_bias.in_features:
        raise ValueError(f"cond_nerf_decode: conditioning width {Gf + 4 * V}, the "
                         f"decoder takes {dec.pts_bias.in_features}")
    small, wts = kernel_weights(dec, matmul_dtype, points_3d.device, kernel)
    postab = postab_table(S, points_3d.device) if cfg.decoder.raytrans_posenc else None
    N = B * R
    out = torch.empty(N, 5, dtype=torch.float32, device=points_3d.device)
    ptrs = (points_3d.data_ptr(), ray_unit.data_ptr(), feat.data_ptr(), color.data_ptr(),
            mask.data_ptr(), depth_samples.data_ptr(), ray.data_ptr(), small.data_ptr(),
            wts.data_ptr(), kernels.ptr(postab), out.data_ptr())
    flags = (_ACT_IDS[raytrans_act_name(cfg)], int(bool(cfg.decoder.density_maskfill)),
             int(bool(cfg.nerf.wo_render_interval)), int(bool(setbg_opaque)))
    variant = "setbg" if setbg_opaque else ""
    if kernel == "C":
        kernels.launch(COUNTER, ROUTES[matmul_dtype], *ptrs, wts.numel() // 16, N, S, Gf, V,
                       *flags, variant=variant)
    else:
        W, D, skips, _, _, _ = decoder_shape(dec)
        L3, Lv = _posenc_freqs(cfg)
        kernels.launch(COUNTER_ANY, ROUTES_ANY[matmul_dtype], *ptrs, small.numel(),
                       wts.numel(), N, S, Gf, V, W, D, sum(1 << l for l in skips), L3, Lv,
                       int(bool(cfg.nerf.legacy_coord)), *flags, variant=variant)
    out = out.reshape(B, R, 5)
    return out[..., 0:3], out[..., 3:4], out[..., 4:5]
