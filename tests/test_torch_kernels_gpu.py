"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked `gpu`: each test skips (with the reason) where no CUDA device is
available, as on a CPU-only host. On a GPU machine run them with
`python -m pytest tests/test_torch_kernels_gpu.py -q`; chip_smoke.py
covers the same kernels at the full DTU shapes.
The prior kernels (B, B', D, D'), C, E and F run at V = 2, 3 and 4 source
views (n_src_views); B, B', D, D' and F at V = 5 raise a ValueError that
names V, with no fallback.
Tolerances: f32 kernels 1e-5 (summation order only), the bf16 window
attention 2e-2 (the plain version rounds the normalised P to bf16 before
P.V, the kernel the unnormalised one), both also at the DTU shape
[24,1280,128] (f32 on split-TF32 tensor cores: 1e-5 still holds);
the forward's logsumexp against torch.logsumexp of the plain masked scores,
1e-3 for f32 and 2e-2 for bf16 inputs, at L = 160 (a ragged last key tile)
and L = 1280. The block-union cosine prior (D) runs at small shapes, at the
largest union it takes (512 rows: the most dynamic shared memory), and with
a ragged R and samples on the border, on int8 tables and on bf16 tables;
also at the eval pose's buckets (160 rows at G = 2, 320 at G = 8, S = 128)
on 1003 rays, and with a bucket below the true unions (the union it builds
overflows: against the plain version at the same ut); the union the kernel
builds equals the plain version's torch build cell for cell. The cosine
prior (B) on int8, bf16 and f32 tables, and on int8 rows that hold every
value -128..127 (its integer-pipe conversion). The supercell colour sample (E) reads
no union: it runs at small shapes, on a 320-supercell union, with a ragged
R and samples on the border, and on grids spread over the whole image whose
union overflows every bucket, where it is also held to the direct gather
on the uint8 image (1e-3 on the 0-255 scale).

The decoder (C) on both operand routes at S = 48, 128, 200 and 256 (one and
two 128-sample tiles) on 149 rays, flagship and demo_own variants: split
TF32 1e-5 (rgb, opacity) and 1e-4 (depth) against the f32 plain version;
bf16 against the bf16 plain twin at 1e-3 and 1e-2, with its mean |d| under
a tenth of the mean gap between the f32 and bf16 twins (the tensor cores
sum the bf16 products in another order, which flips the bf16 rounding of
an activation now and then); with the opaque white background (setbg, on
rays left partly transparent) on both routes at the same tolerances; S
above the kernel's limit raises.

The decoder at other shapes (Cg) on both operand routes at S = 48 and 200
on 149 rays, for the NeRF MLP (256x8, L_view 4), 64x4 skip [2], 64x7 skips
[2, 5], standard coordinates with GELU, a conditioning width of 72, width 34
(padded to 40, its views layer 17 to 24), width 512 (32-sample tiles), and
no encoding (L_3D = L_view = 0); at V = 2 to 8 on the NeRF MLP; with setbg
and render intervals; at the tolerances of C's cases (f32 1e-5 / 1e-4 /
1e-5; bf16 1e-3 / 1e-2 / 1e-3 with the mean check). The wrapper routes each
to Cg (its counter, not C's) and raises beyond Cg's limits before a launch.

The fused interp + grouped cosine (F) on tap rows of int8, bf16 and f32,
with and without dequantisation scales, at G = 2 and 8 and a ragged N, at
V = 3 and at V = 2 and 4 (one template instance each): 1e-5 (summation
order; on int8 rows gathered from a table also against Kernel B, the same
function by another route, at every V).

The training kernels against autograd through the plain versions: A'
(window attention backward; f32 1e-4 and bf16 3e-2 of the largest
gradient, the plain backward rounding dA and A to bf16 where the kernel
keeps f32; both types also at the training shape [24,1280,128], at a
ragged L = 100 and with fewer region rows than windows, and bit-equal
from run to run), B' (cosine-prior table gradient, atomics in any order:
1e-5 of the largest gradient) and D' (f32 block forward 1e-5, and its table
gradient 1e-5 of the largest, also against B', the same function).
The convergence run's train recipe (`matchnerf_tpu_torch.convergence`) for
30 steps on the kernels and all-plain: the mean loss of steps 21-30 within
10 % of the all-plain run's.
"""
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
from matchnerf_tpu_torch.ops import block_cosine_prior as kd
from matchnerf_tpu_torch.ops import cosine_prior as kb
from matchnerf_tpu_torch.ops import decoder as kc
from matchnerf_tpu_torch.ops import fused_cosine as kf
from matchnerf_tpu_torch.ops import supercell_color as ke
from matchnerf_tpu_torch.ops import window_attention as ka
from matchnerf_tpu_torch.ops.attention import shift_region_ids
from matchnerf_tpu_torch.ops.grid_sample import grid_sample_2d, tap_rows_and_weights

pytestmark = pytest.mark.gpu
VIEWS = tuple(range(2, 9))         # n_src_views: the cond-query kernels take 2 to 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shift", [False, True])
def test_window_attention_kernel(dev, dtype, tol, shift):
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(8, 160, 128, generator=g, device=dev).to(dtype) for _ in range(3))
    rid = shift_region_ids(16, 40, 2, device=dev) if shift else None
    before = ka.COUNTER.launches
    got = ka.window_attention(q, k, v, rid)
    assert ka.COUNTER.launches == before + 1
    ref = ka.window_attention_plain(q, k, v, rid)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
def test_window_attention_kernel_dtu_shape(dev, dtype, tol):
    """Shift-masked, at the encoder's eval shape (6 streams x 2x2 windows of
    the 64x80 1/8-scale map): bf16, and f32 on split-TF32 tensor cores."""
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn(24, 1280, 128, generator=g, device=dev).to(dtype)
               for _ in range(3))
    rid = shift_region_ids(64, 80, 2, device=dev)
    got = ka.window_attention(q, k, v, rid)
    ref = ka.window_attention_plain(q, k, v, rid)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hw", [(16, 40), (64, 80)])
def test_window_attention_forward_lse(dev, dtype, tol, hw):
    g = torch.Generator(device=dev).manual_seed(12)
    rid = shift_region_ids(*hw, 2, device=dev)
    L = rid.shape[1]
    q, k, v = (torch.randn(8, L, 128, generator=g, device=dev).to(dtype) for _ in range(3))
    out, lse = ka.window_attention_forward(q, k, v, rid, with_lse=True)
    ref = torch.logsumexp(ka.attention_scores_plain(q, k, rid), dim=-1)
    assert lse.shape == (8, L) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, ref, atol=tol, rtol=0)
    torch.testing.assert_close(out.float(), ka.window_attention_plain(q, k, v, rid).float(),
                               atol=1e-5 if dtype == torch.float32 else 2e-2, rtol=0)


@pytest.mark.parametrize("V", VIEWS)
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [2, 8])
def test_cosine_prior_kernel(dev, dtype, G, V):
    g = torch.Generator(device=dev).manual_seed(1)
    Cc = (V - 1) * 128
    if dtype == torch.int8:
        table = torch.randint(-127, 128, (V, 20, 24, Cc), generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
    else:
        table = torch.randn(V, 20, 24, Cc, generator=g, device=dev).to(dtype)
    scales = torch.rand(V, Cc, generator=g, device=dev) * 0.02 + 1e-3
    grids = torch.rand(V, 37, 48, 2, generator=g, device=dev) * 2.4 - 1.2
    before = kb.COUNTER.launches
    got = kb.cosine_prior(table, grids, scales, G)
    assert kb.COUNTER.launches == before + 1
    ref = kb.cosine_prior_plain(table, grids, scales, G)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def _decode_args(dev, variant, R, S, V=3):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=S)))
    cfg.n_src_views = V
    if variant == "demo_own":
        cfg.decoder = DotDict({**cfg.decoder, "raytrans_act": "ELU",
                               "density_maskfill": True, "raytrans_posenc": True})
    model = init_matchnerf(cfg, torch.Generator().manual_seed(2)).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(3)
    B = 1
    rnd = lambda *s: torch.rand(*s, generator=g, device=dev)
    ray = torch.randn(B, R, 3, generator=g, device=dev)
    unit = (ray / ray.norm(dim=-1, keepdim=True))[:, :, None].expand(B, R, S, 3).contiguous()
    mask = (rnd(B, R, S, V) > 0.4).float()
    mask[:, :5] = 0.0
    cond = {"feat_info": rnd(B, R, S, 10) * 2 - 1, "color_info": rnd(B, R, S, 3 * V),
            "mask_info": mask}
    depth = torch.sort(rnd(B, R, S) * 2.4 + 2.1, dim=-1).values[..., None].contiguous()
    return (model.nerf_dec, cfg, rnd(B, R, S, 3) * 2 - 1, unit, cond, depth, ray)


@pytest.mark.parametrize("V", VIEWS)
@pytest.mark.parametrize("variant", ["flagship", "demo_own"])
def test_cond_nerf_decode_kernel(dev, variant, V):
    """Kernel C at conditioning width Gf + 4V = 18 to 42 (V = 2 to 8)."""
    args = _decode_args(dev, variant, 50, 48, V)
    with torch.no_grad():
        got = kc.cond_nerf_decode(*args)
        ref = kc.cond_nerf_decode_plain(*args)
    for a, b, tol in zip(got, ref, (1e-5, 1e-4, 1e-5)):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)


@pytest.mark.parametrize("route", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [48, 128, 200, 256])
@pytest.mark.parametrize("variant", ["flagship", "demo_own"])
def test_cond_nerf_decode_kernel_routes(dev, variant, S, route):
    """Both operand routes against their plain twins, at S across the
    kernel's 128-sample tiles, on 149 rays (more rays than SMs: blocks take
    two rays, and no tile size divides it). bf16: max |d| 1e-3 (rgb,
    opacity) and 1e-2 (depth), and a mean |d| under a tenth of the mean
    |d| between the f32 and bf16 twins."""
    md = getattr(torch, route)
    args = _decode_args(dev, variant, 149, S)
    with torch.no_grad():
        got = kc.cond_nerf_decode(*args, matmul_dtype=md)
        ref = kc.cond_nerf_decode_plain(*args, matmul_dtype=md)
        other = kc.cond_nerf_decode_plain(
            *args, matmul_dtype=torch.float32 if route == "bfloat16" else torch.bfloat16)
    tols = (1e-5, 1e-4, 1e-5) if route == "float32" else (1e-3, 1e-2, 1e-3)
    for a, b, tol in zip(got, ref, tols):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)
    if route == "bfloat16":
        d = torch.cat([(a - b).abs().flatten() for a, b in zip(got, ref)]).mean()
        gap = torch.cat([(a - b).abs().flatten() for a, b in zip(other, ref)]).mean()
        assert float(d) < 0.1 * float(gap), (float(d), float(gap))


@pytest.mark.parametrize("route", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["flagship", "demo_own"])
def test_cond_nerf_decode_kernel_setbg(dev, variant, route):
    """The opaque (white) background of Blender's renders (setbg = 1) on
    both operand routes, at the tolerances of the routes' cases above, with
    a density head that leaves the rays partly transparent so the
    background shows; the launch counts under `by_variant["setbg"]`."""
    md = getattr(torch, route)
    args = _decode_args(dev, variant, 149, 128)
    head = args[0].out_alpha_linear[2]
    with torch.no_grad():                  # densities ~0.005: opacity ~0.5 over 128 samples
        head.weight.mul_(0.001)
        head.bias.fill_(0.005)
        before = kc.COUNTER.by_variant.get("setbg", 0)
        got = kc.cond_nerf_decode(*args, setbg_opaque=True, matmul_dtype=md)
        assert kc.COUNTER.by_variant["setbg"] == before + 1
        ref = kc.cond_nerf_decode_plain(*args, setbg_opaque=True, matmul_dtype=md)
        black = kc.cond_nerf_decode_plain(*args, matmul_dtype=md)
    tols = (1e-5, 1e-4, 1e-5) if route == "float32" else (1e-3, 1e-2, 1e-3)
    for a, b, tol in zip(got, ref, tols):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)
    assert float((1.0 - ref[2]).mean()) > 0.1
    torch.testing.assert_close(ref[0], black[0] + (1.0 - black[2]), atol=1e-5, rtol=0)


def test_cond_nerf_decode_kernel_sample_limit(dev):
    args = _decode_args(dev, "flagship", 3, kc.S_MAX + 1)
    with torch.no_grad(), pytest.raises(ValueError, match=f"S <= {kc.S_MAX}"):
        kc.cond_nerf_decode(*args)


CG_DECODERS = {
    "nerf_mlp": {"net_width": 256, "net_depth": 8, "posenc": {"L_3D": 10, "L_view": 4}},
    "w64_d4_skip2": {"net_width": 64, "net_depth": 4, "skip": [2]},
    "w64_d7_skips_2_5": {"net_width": 64, "net_depth": 7, "skip": [2, 5]},
    "standard_gelu": {"raytrans_act": "GELU", "legacy_coord": False},
    "cond_72": {"cos_n_group": [30, 30]},
    "w34": {"net_width": 34, "net_depth": 3, "skip": [0]},
    "w512_d2": {"net_width": 512, "net_depth": 2, "skip": []},
    "no_encoding": {"posenc": {"L_3D": 0, "L_view": 0}, "raytrans_posenc": True,
                    "density_maskfill": True},
}


def _cg_args(dev, keys, R, S, V=3, seed=2):
    """A seeded CondNeRF of the tiny config with `keys` (decoder keys; also
    legacy_coord and cos_n_group), its biases moved off zero, and the
    decoder's inputs as _decode_args draws them."""
    from matchnerf_tpu_torch.models.decoder.cond_nerf import CondNeRF
    from matchnerf_tpu_torch.ops.nn import reset_parameters
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=S)))
    cfg.n_src_views = V
    keys = dict(keys)
    cfg.nerf = DotDict({**cfg.nerf, "legacy_coord": keys.pop("legacy_coord", True)})
    cfg.encoder = DotDict({**cfg.encoder,
                           "cos_n_group": keys.pop("cos_n_group", [2, 8])})
    cfg.decoder = DotDict({**cfg.decoder, **keys})
    g = torch.Generator().manual_seed(seed)
    dec = reset_parameters(CondNeRF(cfg), g)
    with torch.no_grad():
        for p in dec.parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    args = _decode_args(dev, "flagship", R, S, V)
    Gf = int(sum(cfg.encoder.cos_n_group))
    cond = dict(args[4])
    gd = torch.Generator(device=dev).manual_seed(seed + 1)
    cond["feat_info"] = torch.rand(1, R, S, Gf, generator=gd, device=dev) * 2 - 1
    return (dec.to(dev).eval(), cfg, args[2], args[3], cond, args[5], args[6])


def _check_cg(args, md, setbg=False):
    c0, g0 = kc.COUNTER.launches, kc.COUNTER_ANY.launches
    with torch.no_grad():
        got = kc.cond_nerf_decode(*args, setbg_opaque=setbg, matmul_dtype=md)
        ref = kc.cond_nerf_decode_plain(*args, setbg_opaque=setbg, matmul_dtype=md)
        other = kc.cond_nerf_decode_plain(
            *args, setbg_opaque=setbg,
            matmul_dtype=torch.float32 if md == torch.bfloat16 else torch.bfloat16)
    assert (kc.COUNTER.launches - c0, kc.COUNTER_ANY.launches - g0) == (0, 1)
    tols = (1e-5, 1e-4, 1e-5) if md == torch.float32 else (1e-3, 1e-2, 1e-3)
    for a, b, tol in zip(got, ref, tols):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)
    if md == torch.bfloat16:
        d = torch.cat([(a - b).abs().flatten() for a, b in zip(got, ref)]).mean()
        gap = torch.cat([(a - b).abs().flatten() for a, b in zip(other, ref)]).mean()
        assert float(d) < 0.1 * float(gap), (float(d), float(gap))
    return got, ref


@pytest.mark.parametrize("route", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [48, 200])
@pytest.mark.parametrize("name", list(CG_DECODERS))
def test_cond_nerf_decode_any_kernel(dev, name, S, route):
    """Kernel Cg against its plain twin on each decoder and route."""
    args = _cg_args(dev, CG_DECODERS[name], 149, S)
    assert kc.decoder_route(args[0], args[1], S) == "Cg"
    _check_cg(args, getattr(torch, route))


@pytest.mark.parametrize("V", VIEWS)
def test_cond_nerf_decode_any_kernel_views(dev, V):
    """Kernel Cg on the NeRF MLP at V = 2 to 8 (Gf + 4V = 18 to 42)."""
    _check_cg(_cg_args(dev, CG_DECODERS["nerf_mlp"], 50, 48, V), torch.float32)


@pytest.mark.parametrize("route", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["setbg", "intervals"])
def test_cond_nerf_decode_any_kernel_composite(dev, case, route):
    """At S = 512 (the kernel's limit): setbg on rays left partly
    transparent (the background shows; counted under by_variant), and the
    render intervals (wo_render_interval false: density x interval x |ray|,
    the last interval 1e10)."""
    args = _cg_args(dev, CG_DECODERS["nerf_mlp"], 40, 512)
    setbg = case == "setbg"
    if setbg:
        head = args[0].out_alpha_linear[2]
        with torch.no_grad():
            head.weight.mul_(0.001)
            head.bias.fill_(0.002)
    else:
        args[1].nerf = DotDict({**args[1].nerf, "wo_render_interval": False})
    before = kc.COUNTER_ANY.by_variant.get("setbg", 0)
    got, ref = _check_cg(args, getattr(torch, route), setbg=setbg)
    assert kc.COUNTER_ANY.by_variant.get("setbg", 0) == before + setbg
    if setbg:
        assert float((1.0 - ref[2]).mean()) > 0.1


def test_cond_nerf_decode_any_limits(dev):
    """Beyond Cg's limits the wrapper raises before any launch."""
    for keys, S, match in (({"net_width": 514}, 16, "net_width"), ({"net_width": 64}, 513,
                                                                     "S <= 512"),
                           ({"cos_n_group": [60, 60]}, 16, "Gf \\+ 4V <= 128")):
        args = _cg_args(dev, keys, 3, S)
        c0, g0 = kc.COUNTER.launches, kc.COUNTER_ANY.launches
        with torch.no_grad(), pytest.raises(ValueError, match=match):
            kc.cond_nerf_decode(*args)
        assert (kc.COUNTER.launches, kc.COUNTER_ANY.launches) == (c0, g0)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_scales", [False, True])
@pytest.mark.parametrize("G", [2, 8])
def test_fused_cosine_kernel(dev, dtype, with_scales, G):
    g = torch.Generator(device=dev).manual_seed(9)
    N = 1237                                     # not a multiple of 16 samples per block
    if dtype == torch.int8:
        rows = torch.randint(-127, 128, (3, N, 1024), generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)
    else:
        rows = torch.randn(3, N, 1024, generator=g, device=dev).to(dtype)
    weights = torch.rand(3, N, 2, generator=g, device=dev)
    scales = (torch.rand(3, 256, generator=g, device=dev) * 0.02 + 1e-3
              if with_scales else None)
    before = kf.COUNTER.launches
    got = kf.fused_interp_grouped_cosine(rows, weights, G, scales)
    torch.cuda.synchronize()
    assert kf.COUNTER.launches == before + 1
    ref = kf.fused_interp_grouped_cosine_plain(rows, weights, G, scales)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("G", [2, 8])
def test_fused_cosine_matches_cosine_prior(dev, G):
    g = torch.Generator(device=dev).manual_seed(10)
    table, scales = _int8_table(g, dev, 20, 24)
    grids = torch.rand(3, 37, 48, 2, generator=g, device=dev) * 2.4 - 1.2
    taps = [tap_rows_and_weights(table[v], grids[v]) for v in range(3)]
    rows = torch.stack([t[0] for t in taps])
    weights = torch.stack([t[1] for t in taps])
    got = kf.fused_interp_grouped_cosine(rows, weights, G, scales).reshape(37, 48, G)
    torch.testing.assert_close(got, kb.cosine_prior(table, grids, scales, G), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("V", [2, 4, 5, 6, 8])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_scales", [False, True])
@pytest.mark.parametrize("G", [2, 8])
def test_fused_cosine_kernel_views(dev, V, dtype, with_scales, G):
    """F at V = 2 to 8: rows [V,N,512(V-1)], P = V(V-1)/2 pairs."""
    g = torch.Generator(device=dev).manual_seed(19 + V)
    N = 1237
    width = 512 * (V - 1)
    if dtype == torch.int8:
        rows = torch.randint(-127, 128, (V, N, width), generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)
    else:
        rows = torch.randn(V, N, width, generator=g, device=dev).to(dtype)
    weights = torch.rand(V, N, 2, generator=g, device=dev)
    scales = (torch.rand(V, 128 * (V - 1), generator=g, device=dev) * 0.02 + 1e-3
              if with_scales else None)
    before = (kf.COUNTER.launches, kf.COUNTER.plain_on_cuda)
    got = kf.fused_interp_grouped_cosine(rows, weights, G, scales)
    torch.cuda.synchronize()
    assert (kf.COUNTER.launches, kf.COUNTER.plain_on_cuda) == (before[0] + 1, before[1])
    ref = kf.fused_interp_grouped_cosine_plain(rows, weights, G, scales)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("V", [2, 4, 5, 8])
def test_fused_cosine_views_match_cosine_prior(dev, V):
    g = torch.Generator(device=dev).manual_seed(29 + V)
    table, scales = _int8_table(g, dev, 20, 24, V)
    grids = torch.rand(V, 37, 48, 2, generator=g, device=dev) * 2.4 - 1.2
    taps = [tap_rows_and_weights(table[v], grids[v]) for v in range(V)]
    rows = torch.stack([t[0] for t in taps])
    weights = torch.stack([t[1] for t in taps])
    got = kf.fused_interp_grouped_cosine(rows, weights, 8, scales).reshape(37, 48, 8)
    torch.testing.assert_close(got, kb.cosine_prior(table, grids, scales, 8), atol=1e-5,
                               rtol=0)


def _block_grids(g, dev, V, R, S, spread):
    """Grids whose 8-ray blocks share their neighbourhood: one random start
    per block, a small jitter per ray, straight segments of `spread`."""
    nb = (R + 7) // 8
    start = torch.rand(V, nb, 1, 2, generator=g, device=dev) * 2.2 - 1.1
    start = (start + torch.randn(V, nb, 8, 2, generator=g, device=dev) * 0.01)
    start = start.reshape(V, nb * 8, 2)[:, :R]
    step = (torch.rand(V, R, 2, generator=g, device=dev) - 0.5) * spread
    t = torch.linspace(0, 1, S, device=dev)[None, None, :, None]
    return (start[:, :, None] + step[:, :, None] * t).contiguous()


def _int8_table(g, dev, h, w, V=3):
    table = torch.randint(-127, 128, (V, h, w, (V - 1) * 128), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
    scales = torch.rand(V, (V - 1) * 128, generator=g, device=dev) * 0.02 + 1e-3
    return table, scales


@pytest.mark.parametrize("V", VIEWS)
@pytest.mark.parametrize("G", [2, 8])
@pytest.mark.parametrize("case", ["small", "cap_512", "ragged_border"])
def test_block_cosine_prior_kernel(dev, case, G, V):
    g = torch.Generator(device=dev).manual_seed(4)
    if case == "small":
        table, scales = _int8_table(g, dev, 20, 24, V)
        grids = _block_grids(g, dev, V, 40, 48, 0.3)
    elif case == "cap_512":
        # random cells in a wide table: ~4 x 8 x 15 dilated rows per block
        table, scales = _int8_table(g, dev, 64, 80, V)
        grids = torch.rand(V, 16, 15, 2, generator=g, device=dev) * 2 - 1
    else:
        table, scales = _int8_table(g, dev, 16, 16, V)
        grids = _block_grids(g, dev, V, 13, 32, 0.5)
        grids[:, :, :4] = torch.clamp(grids[:, :, :4] * 3.0, -1.0, 1.0)
        grids[:, -1, -2:] = 1.0                               # the last cell
    h, w = table.shape[1:3]
    ut = kd.bucket_ut(kd.block_union_size_raw(kd.pad_rays(grids), h, w))
    if case == "cap_512":
        assert ut == 512
    before = kd.COUNTER.launches
    got = kd.block_cosine_prior(table, grids, scales, G, ut)
    torch.cuda.synchronize()
    assert kd.COUNTER.launches == before + 1
    ref = kd.block_cosine_prior_plain(table, grids, scales, G, ut)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    if case != "cap_512":
        # the same function as Kernel B
        torch.testing.assert_close(got, kb.cosine_prior(table, grids, scales, G),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("V", VIEWS)
@pytest.mark.parametrize("G", [2, 8])
@pytest.mark.parametrize("case", ["small", "cap_512", "ragged_border"])
def test_block_cosine_prior_bf16_kernel(dev, case, G, V):
    """Kernel D on bf16 tables (no scales): the staged-pass kernel at
    CP = 128 or, for ut 512, 64 channels a pass; against its plain version
    and Kernel B's bf16 form."""
    g = torch.Generator(device=dev).manual_seed(5)
    h, w = {"small": (20, 24), "cap_512": (64, 80), "ragged_border": (16, 16)}[case]
    table = torch.randn(V, h, w, (V - 1) * 128, generator=g, device=dev).to(torch.bfloat16)
    if case == "small":
        grids = _block_grids(g, dev, V, 40, 48, 0.3)
    elif case == "cap_512":
        grids = torch.rand(V, 16, 15, 2, generator=g, device=dev) * 2 - 1
    else:
        grids = _block_grids(g, dev, V, 13, 32, 0.5)
        grids[:, :, :4] = torch.clamp(grids[:, :, :4] * 3.0, -1.0, 1.0)
        grids[:, -1, -2:] = 1.0
    ut = kd.bucket_ut(kd.block_union_size_raw(kd.pad_rays(grids), h, w))
    assert kd.takes_bf16(ut, grids.shape[2], G, n_views=V)
    before = kd.COUNTER.by_entry.get("block_cosine_prior_bf16", 0)
    got = kd.block_cosine_prior(table, grids, None, G, ut)
    torch.cuda.synchronize()
    assert kd.COUNTER.by_entry["block_cosine_prior_bf16"] == before + 1
    ref = kd.block_cosine_prior_plain(table, grids, None, G, ut)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    if case != "cap_512":
        torch.testing.assert_close(got, kb.cosine_prior(table, grids, None, G),
                                   atol=1e-5, rtol=0)


def _d_table(g, dev, dtype, h, w, V=3):
    if dtype == torch.int8:
        return _int8_table(g, dev, h, w, V)
    return torch.randn(V, h, w, (V - 1) * 128, generator=g, device=dev).to(dtype), None


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("G", [2, 8])
def test_block_cosine_prior_overflowed_union(dev, dtype, G):
    """Kernel D with a bucket below the blocks' true unions: the kernel's
    union keeps the first ut cells in ascending order at both capping steps,
    a tap outside them adds 0, as in the plain version at the same ut."""
    g = torch.Generator(device=dev).manual_seed(13)
    table, scales = _d_table(g, dev, dtype, 64, 80)
    grids = _block_grids(g, dev, 3, 45, 64, 1.2)
    true = kd.block_union_size_raw(kd.pad_rays(grids), 64, 80)
    ut = 128
    assert true > ut, true
    got = kd.block_cosine_prior(table, grids, scales, G, ut)
    ref = kd.block_cosine_prior_plain(table, grids, scales, G, ut)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    full = kd.block_cosine_prior_plain(table, grids, scales, G, kd.bucket_ut(true))
    assert float((got - full).abs().max()) > 1e-3       # the overflow dropped taps


@pytest.mark.parametrize("V", VIEWS)
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("hw,G,ut", [((64, 80), 2, 160), ((128, 160), 8, 320)])
def test_block_cosine_prior_eval_buckets(dev, dtype, hw, G, ut, V):
    """Kernel D at the eval pose's buckets and group counts (160 rows at
    G = 2 on the 1/8-scale table, 320 at G = 8 on the 1/4-scale one), S =
    128, on 1003 rays (not a multiple of 8: the tail block repeats the last
    ray), unions that fill the bucket without overflowing it; at V >= 4 and
    ut 320 in 64-channel passes."""
    g = torch.Generator(device=dev).manual_seed(14)
    table, scales = _d_table(g, dev, dtype, *hw, V)
    assert kd.channels_per_pass(ut, 128, G, False, 2, hw[0] * hw[1], V) == \
        (64 if V >= 4 and ut == 320 else 128)
    fits = []                          # the widest spread whose union fits
    for spread in (0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.7, 0.9, 1.2):
        cand = _block_grids(g, dev, V, 1003, 128, spread)
        n = kd.block_union_size_raw(kd.pad_rays(cand), *hw)
        if n <= ut:
            fits.append((n, cand))
    n, grids = max(fits, key=lambda f: f[0])
    assert n > ut // 4, n
    before = kd.COUNTER.by_entry.get(kd.ENTRIES[dtype], 0)
    got = kd.block_cosine_prior(table, grids, scales, G, ut)
    torch.cuda.synchronize()
    assert kd.COUNTER.by_entry[kd.ENTRIES[dtype]] == before + 1
    torch.testing.assert_close(got, kd.block_cosine_prior_plain(table, grids, scales, G, ut),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(got, kb.cosine_prior(table, grids, scales, G), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("case", ["fits", "overflow", "ragged_border"])
def test_block_union_built_in_kernel(dev, case):
    """The union D''s forward kernel writes for its backward equals the
    plain version's torch build (`block_unions`) cell for cell, -1 padded,
    also where it overflows the bucket."""
    g = torch.Generator(device=dev).manual_seed(15)
    h, w = (16, 16) if case == "ragged_border" else (64, 80)
    table = _f32_table(g, dev, h, w)
    if case == "ragged_border":
        grids = _block_grids(g, dev, 3, 13, 32, 0.5)
        grids[:, :, :4] = torch.clamp(grids[:, :, :4] * 3.0, -1.0, 1.0)
        grids[:, -1, -2:] = 1.0
    else:
        grids = _block_grids(g, dev, 3, 37, 48, 1.2 if case == "overflow" else 0.3)
    gp = kd.pad_rays(grids)
    true = kd.block_union_size_raw(gp, h, w)
    ut = 64 if case == "overflow" else kd.bucket_ut(true)
    assert (true > ut) == (case == "overflow"), (true, ut)
    _, unions = kd._forward(table, grids, None, 2, ut, with_unions=True)
    torch.testing.assert_close(unions, kd.block_unions(gp, h, w, ut), atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_block_cosine_prior_table_size_limit(dev, dtype):
    """Kernel D's union build keeps bitmaps of the table's h*w cells in
    shared memory. At the largest table that `takes_table` sends to it (S =
    128, ut 512, G = 8, W = 1024) the kernel matches its plain version; one
    row more and the route is Kernel B, which matches its own, while Kernel
    D refuses the table."""
    G, ut, W, S = 8, 512, 1024, 128
    h = 1
    while kd.takes_bf16(ut, S, G, (h + 1) * W):
        h += 1
    g = torch.Generator(device=dev).manual_seed(17)
    grids = _block_grids(g, dev, 3, 21, S, 0.4)
    for rows, block in ((h, True), (h + 1, False)):
        table, scales = _d_table(g, dev, dtype, rows, W)
        assert kd.takes_table(table, scales, ut, S, G) == block
        if block:
            got = kd.block_cosine_prior(table, grids, scales, G, ut)
            ref = kd.block_cosine_prior_plain(table, grids, scales, G, ut)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                kd.block_cosine_prior(table, grids, scales, G, ut)
            got = kb.cosine_prior(table, grids, scales, G)
            ref = kb.cosine_prior_plain(table, grids, scales, G)
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
        del table


@pytest.mark.parametrize("G", [2, 8, 16])
def test_cosine_prior_kernel_every_int8(dev, G):
    """Kernel B on an int8 table whose rows hold every value -128..127, so
    that its integer-pipe conversion is checked on all 256, against the
    plain version."""
    g = torch.Generator(device=dev).manual_seed(16)
    vals = torch.arange(-128, 128, device=dev, dtype=torch.int32)
    idx = torch.stack([torch.randperm(256, generator=g, device=dev)
                       for _ in range(3 * 20 * 24)])
    table = vals[idx].reshape(3, 20, 24, 256).to(torch.int8).contiguous()
    scales = torch.rand(3, 256, generator=g, device=dev) * 0.02 + 1e-3
    grids = torch.rand(3, 37, 48, 2, generator=g, device=dev) * 2.4 - 1.2
    grids[:, :, :6] = torch.round(grids[:, :, :6] * 10) / 10   # taps on cell corners
    got = kb.cosine_prior(table, grids, scales, G)
    torch.testing.assert_close(got, kb.cosine_prior_plain(table, grids, scales, G), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("V", VIEWS)
@pytest.mark.parametrize("case", ["small", "cap_320", "ragged_border", "overflow"])
def test_supercell_color_kernel(dev, case, V):
    g = torch.Generator(device=dev).manual_seed(5)
    img_h, img_w = 50, 66
    if case == "cap_320":
        img_h, img_w = 200, 240
        grids = torch.rand(V, 16, 40, 2, generator=g, device=dev) * 2 - 1
    elif case == "small":
        grids = _block_grids(g, dev, V, 24, 48, 0.4)
    elif case == "overflow":
        img_h, img_w = 200, 240
        grids = torch.rand(V, 21, 64, 2, generator=g, device=dev) * 2.1 - 1.05
    else:
        grids = _block_grids(g, dev, V, 13, 32, 0.5)
        grids[:, :, :4] = torch.clamp(grids[:, :, :4] * 3.0, -1.0, 1.0)
        grids[:, -1, -2:] = 1.0
    images = torch.randint(0, 256, (V, img_h, img_w, 3), generator=g, device=dev,
                           dtype=torch.int32).to(torch.uint8)
    table = ke.build_supercell_colors(images)
    ut = ke.bucket_color_ut(ke.color_union_size(kd.pad_rays(grids), img_h, img_w))
    if case == "cap_320":
        assert ut == 320
    if case == "overflow":
        assert ut is None
    before = ke.COUNTER.launches
    got = ke.supercell_color_sample(table, grids, img_h, img_w)
    torch.cuda.synchronize()
    assert ke.COUNTER.launches == before + 1
    ref = ke.supercell_color_sample_plain(table, grids, img_h, img_w)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    if case == "overflow":
        R, S = grids.shape[1:3]
        direct = torch.stack([grid_sample_2d(images[v:v + 1], grids[v:v + 1])[0]
                              for v in range(V)], dim=2).reshape(R, S, 3 * V)
        torch.testing.assert_close(got, direct, atol=1e-3, rtol=0)


def _grad_close(got, ref, rel):
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=rel * float(ref.float().abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shift", [False, True])
def test_window_attention_backward_kernel(dev, dtype, tol, shift):
    g = torch.Generator(device=dev).manual_seed(6)
    # L = 160: two full 64-row tiles and a ragged one
    q, k, v, do = (torch.randn(8, 160, 128, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    rid = shift_region_ids(16, 40, 2, device=dev) if shift else None
    grads = []
    for fn in (ka.window_attention, ka.window_attention_plain):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        before = (ka.COUNTER.launches, ka.BWD_COUNTER.launches)
        out = fn(qq, kk, vv, rid)
        out.backward(do)
        torch.cuda.synchronize()
        if fn is ka.window_attention:
            assert (ka.COUNTER.launches, ka.BWD_COUNTER.launches) == \
                (before[0] + 1, before[1] + 1)
        grads.append((out.detach(), qq.grad, kk.grad, vv.grad))
    for a, b in zip(*grads):
        assert a.dtype == dtype
        _grad_close(a, b, tol)


def _window_grads(fn, q, k, v, do, rid):
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = fn(qq, kk, vv, rid)
    out.backward(do)
    torch.cuda.synchronize()
    return out.detach(), qq.grad, kk.grad, vv.grad


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("case", ["dtu_unmasked", "dtu_shift", "ragged_L100_unmasked",
                                  "ragged_L100_shift", "n_rid_3_of_7"])
def test_window_attention_backward_bf16_cases(dev, case, dtype, tol):
    """The bf16 and f32 backward against autograd through the plain version,
    3e-2 (bf16) and 1e-4 (f32) of the largest gradient: at the training
    shape [24,1280,128] (2x2 windows of the 64x80 1/8-scale map), at L = 100
    (not a multiple of 16: one partial tile of keys and of queries), and
    with 3 region rows for 7 windows (window w takes row w % 3)."""
    g = torch.Generator(device=dev).manual_seed(13)
    if case.startswith("dtu"):
        bw, hw = 24, (64, 80)
    elif case.startswith("ragged"):
        bw, hw = 8, (20, 20)
    else:
        bw, hw = 7, (16, 40)
    rid = shift_region_ids(*hw, 2, device=dev)
    L = rid.shape[1]
    if case == "n_rid_3_of_7":
        rid = torch.randint(0, 4, (3, L), generator=g, device=dev, dtype=torch.int32)
    elif case.endswith("unmasked"):
        rid = None
    q, k, v, do = (torch.randn(bw, L, 128, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    before = ka.BWD_COUNTER.launches
    got = _window_grads(ka.window_attention, q, k, v, do, rid)
    assert ka.BWD_COUNTER.launches == before + 1
    ref = _window_grads(ka.window_attention_plain, q, k, v, do, rid)
    for a, b in zip(got, ref):
        assert a.dtype == dtype and bool(torch.isfinite(a).all())
        _grad_close(a, b, tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_attention_backward_bf16_deterministic(dev, dtype):
    """Two launches and no atomics: the same inputs give dq, dk and dv bit
    for bit, bf16 and f32."""
    g = torch.Generator(device=dev).manual_seed(14)
    rid = shift_region_ids(64, 80, 2, device=dev)
    q, k, v, do = (torch.randn(24, 1280, 128, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    first = _window_grads(ka.window_attention, q, k, v, do, rid)[1:]
    second = _window_grads(ka.window_attention, q, k, v, do, rid)[1:]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _f32_table(g, dev, h, w, V=3):
    return torch.randn(V, h, w, (V - 1) * 128, generator=g, device=dev)


def _edge_rays(g, dev, grids):
    """Overwrite rays 0-6 of grids [V,R,S,2] with the walks' edge cases: 0-1
    inside one cell (the longest run), 2 along the right border, 3 past the
    bottom border, 4 into the bottom-right corner (coincident taps), 5-6 a
    zigzag that leaves a cell and comes back."""
    V, S = grids.shape[0], grids.shape[2]
    t = torch.linspace(0, 1, S, device=dev)
    grids[:, 0:2] = grids[:, 0:2, :1] + torch.rand(V, 2, S, 2, generator=g, device=dev) * 1e-3
    grids[:, 2, :, 0], grids[:, 2, :, 1] = 1.0, t * 1.5 - 0.8
    grids[:, 3, :, 0], grids[:, 3, :, 1] = t * 1.4 - 0.5, 1.3
    grids[:, 4] = (t * 0.4 + 0.8)[:, None]
    zig = ((torch.arange(S, device=dev) / 3.0) % 2.0 - 1.0).abs()
    grids[:, 5:7] = grids[:, 5:7, :1] + 0.4 * zig[None, None, :, None]
    return grids.contiguous()


def _train_rays(g, dev, R, S, strips, V=3):
    """R training rays of S samples: iid straight segments, or with `strips`
    8-ray blocks that start together, as the 8-pixel strips of
    configs/train_fast.yaml."""
    if strips:
        return _block_grids(g, dev, V, R, S, 0.4)
    start = torch.rand(V, R, 1, 2, generator=g, device=dev) * 2.0 - 1.0
    step = (torch.rand(V, R, 1, 2, generator=g, device=dev) - 0.5) * 0.8
    return (start + step * torch.linspace(0, 1, S, device=dev)[None, None, :, None]).contiguous()


@pytest.mark.parametrize("V", VIEWS)
@pytest.mark.parametrize("G,case", [(2, "small"), (8, "small"), (1, "edge"), (2, "edge"),
                                    (4, "edge"), (8, "edge"), (16, "edge"),
                                    (2, "train_64x80"), (8, "train_128x160")])
def test_cosine_prior_backward_kernel(dev, G, case, V):
    """B' against autograd through the plain twin, 1e-5 of the largest
    gradient: rays that stay in one cell, run along the borders and revisit
    a cell, 37 x 48 = 1776 samples (not a multiple of a walk or a block),
    and the training shapes (1024 iid rays x 128 on 64x80 and 128x160
    tables)."""
    g = torch.Generator(device=dev).manual_seed(7)
    if case.startswith("train"):
        h, w = (64, 80) if case == "train_64x80" else (128, 160)
        table = _f32_table(g, dev, h, w, V)
        grids = _train_rays(g, dev, 1024, 128, strips=False, V=V)
    else:
        table = _f32_table(g, dev, 20, 24, V)
        grids = _block_grids(g, dev, V, 37, 48, 0.4)
        grids[:, :3, :4] = torch.clamp(grids[:, :3, :4] * 3.0, -1.0, 1.0)
        if case == "edge":
            grids = _edge_rays(g, dev, grids)
    R, S = grids.shape[1:3]
    gcot = torch.randn(R, S, G, generator=g, device=dev)
    grads = []
    for fn in (kb.cosine_prior, kb.cosine_prior_plain):
        t = table.clone().requires_grad_()
        before = kb.BWD_COUNTER.launches
        fn(t, grids, None, G).backward(gcot)
        torch.cuda.synchronize()
        if fn is kb.cosine_prior:
            assert kb.BWD_COUNTER.launches == before + 1
        grads.append(t.grad)
    _grad_close(grads[0], grads[1], 1e-5)


@pytest.mark.parametrize("V", VIEWS)
@pytest.mark.parametrize("G,case", [(2, "small"), (8, "small"), (2, "ragged_border"),
                                    (8, "ut_320"), (1, "edge"), (2, "edge"), (4, "edge"),
                                    (8, "edge"), (16, "edge"), (2, "train_64x80"),
                                    (8, "train_128x160"), (2, "overflow"), (8, "overflow")])
def test_block_cosine_prior_f32_kernels(dev, G, case, V):
    """D''s forward (1e-5) and backward (1e-5 of the largest gradient)
    against autograd through the plain twin and, where the union holds every
    tap, through Kernels B and B' (the same function): small and ragged
    blocks; the widest union at G = 8; rays that stay in one cell, run along
    the borders and revisit a cell in a ragged block (37 rays); the training
    shapes (1024 rays x 128 in 8-ray strips on 64x80 and 128x160 tables);
    and a bucket below the union (taps missing from it add nothing)."""
    g = torch.Generator(device=dev).manual_seed(8)
    if case == "ut_320":
        # wide segments in a 64 x 80 table at S = 128: the widest union D'
        # stages at G = 8 (bucket 256 or 320 at V = 2 and 3, 256 at V = 4
        # and 5, 192 at V = 6 and 7, 160 at V = 8, found in finer steps of
        # the spread past V = 4; 32-channel backward passes)
        cap = max(u for u in kd.UT_BUCKETS if kd.takes_f32(u, 128, G, n_views=V))
        table = _f32_table(g, dev, 64, 80, V)
        spreads = ((1.2, 1.0, 0.8, 0.6, 0.5, 0.4, 0.3) if V <= 4
                   else [round(1.2 - 0.05 * i, 2) for i in range(19)])
        for spread in spreads:
            grids = _block_grids(g, dev, V, 24, 128, spread)
            if kd.block_union_size_raw(kd.pad_rays(grids), 64, 80) <= cap:
                break
    elif case.startswith("train"):
        h, w = (64, 80) if case == "train_64x80" else (128, 160)
        table = _f32_table(g, dev, h, w, V)
        for spread in (0.4, 0.3, 0.2, 0.1, 0.05):
            grids = _block_grids(g, dev, V, 1024, 128, spread)
            ut = kd.bucket_ut(kd.block_union_size_raw(kd.pad_rays(grids), h, w))
            if ut is not None and kd.takes_f32(ut, 128, G, n_views=V):
                break
    elif case in ("small", "overflow"):
        table = _f32_table(g, dev, 20, 24, V)
        grids = _block_grids(g, dev, V, 40, 48, 0.3 if case == "small" else 1.5)
    elif case == "edge":
        # G = 1 stages 128 channels a pass: a union of <= 96 rows at S = 16
        h, w, S = (16, 16, 16) if G == 1 else (20, 24, 48)
        table = _f32_table(g, dev, h, w, V)
        for spread in (0.2, 0.1, 0.05) if G == 1 else (0.4, 0.2, 0.1):
            grids = _edge_rays(g, dev, _block_grids(g, dev, V, 37, S, spread))
            ut = kd.bucket_ut(kd.block_union_size_raw(kd.pad_rays(grids), h, w))
            if ut is not None and kd.takes_f32(ut, S, G, n_views=V):
                break
    else:
        table = _f32_table(g, dev, 16, 16, V)
        grids = _block_grids(g, dev, V, 13, 32, 0.5)
        grids[:, :, :4] = torch.clamp(grids[:, :, :4] * 3.0, -1.0, 1.0)
        grids[:, -1, -2:] = 1.0
    h, w = table.shape[1:3]
    R, S = grids.shape[1:3]
    union = kd.block_union_size_raw(kd.pad_rays(grids), h, w)
    ut = 64 if case == "overflow" else kd.bucket_ut(union)
    assert kd.takes_f32(ut, S, G, n_views=V), (ut, S, G, V)
    assert (union > ut) == (case == "overflow"), (union, ut)
    if case == "ut_320":
        assert ut >= min(192, cap), (ut, cap)
    gcot = torch.randn(R, S, G, generator=g, device=dev)
    outs, grads = [], []
    for fn in (kd.block_cosine_prior, kd.block_cosine_prior_plain,
               lambda t, gr, sc, G_, ut_: kb.cosine_prior(t, gr, sc, G_)):
        t = table.clone().requires_grad_()
        before = (kd.F32_COUNTER.launches, kd.BWD_COUNTER.launches)
        out = fn(t, grids, None, G, ut)
        out.backward(gcot)
        torch.cuda.synchronize()
        if fn is kd.block_cosine_prior:
            assert (kd.F32_COUNTER.launches, kd.BWD_COUNTER.launches) == \
                (before[0] + 1, before[1] + 1)
        outs.append(out.detach())
        grads.append(t.grad)
    with torch.no_grad():           # the forward alone, as the eval path calls it
        torch.testing.assert_close(kd.block_cosine_prior(table, grids, None, G, ut), outs[1],
                                   atol=1e-5, rtol=0)
    for i in (1, 2) if union <= ut else (1,):   # vs the plain twin, and vs Kernels B and B'
        torch.testing.assert_close(outs[0], outs[i], atol=1e-5, rtol=0)
        _grad_close(grads[0], grads[i], 1e-5)


@pytest.mark.parametrize("kernel", ["B'", "D'"])
def test_prior_backward_runs_agree(dev, kernel):
    """Two runs of B' and of D''s backward at the training shape of scale 1
    (1024 rays x 128, 128x160 table, G = 8) give the same bits: each cell's
    runs are summed in an order fixed by the input."""
    g = torch.Generator(device=dev).manual_seed(16)
    table = _f32_table(g, dev, 128, 160)
    grids = _train_rays(g, dev, 1024, 128, strips=kernel == "D'")
    gcot = torch.randn(1024, 128, 8, generator=g, device=dev)
    if kernel == "B'":
        fn = lambda t: kb.cosine_prior(t, grids, None, 8)
    else:
        ut = kd.bucket_ut(kd.block_union_size_raw(kd.pad_rays(grids), 128, 160))
        assert kd.takes_f32(ut, 128, 8), ut
        fn = lambda t: kd.block_cosine_prior(t, grids, None, 8, ut)
    runs = []
    for _ in range(2):
        t = table.clone().requires_grad_()
        fn(t).backward(gcot)
        runs.append(t.grad)
    assert torch.equal(runs[0], runs[1])


def _strip_grids_taken(g, dev, V, R, S, G, h, w):
    """8-ray strips whose union bucket D' takes at V views (the spread
    narrowed until it fits) -> (grids, ut)."""
    for spread in (0.4, 0.3, 0.2, 0.1, 0.05, 0.02, 0.01):
        grids = _block_grids(g, dev, V, R, S, spread)
        ut = kd.bucket_ut(kd.block_union_size_raw(kd.pad_rays(grids), h, w))
        if ut is not None and kd.takes_f32(ut, S, G, n_views=V):
            return grids, ut
    raise AssertionError(f"no strips D' takes at V={V} G={G}")


@pytest.mark.parametrize("V", [2, 3, 8])
@pytest.mark.parametrize("case", ["train_64x80", "train_128x160", "edge"])
@pytest.mark.parametrize("kernel", ["B'", "D'"])
def test_prior_backward_bit_equal(dev, kernel, case, V):
    """B' and D''s backward launched twice on the same inputs give
    torch.equal gradients: the training shapes of both scales (1024 rays x
    128 at G = 2 on 64x80 tables and G = 8 on 128x160; iid rays for B',
    8-pixel strips for D') and the walks' edge cases of `_edge_rays` (37
    rays x 48 on a 20x24 table, G = 2), each also within 1e-5 of the
    largest gradient of the plain twin."""
    g = torch.Generator(device=dev).manual_seed(21)
    if case == "edge":
        (h, w), R, S, G = (20, 24), 37, 48, 2
    else:
        (h, w), R, S, G = ((64, 80), 1024, 128, 2) if case == "train_64x80" else \
            ((128, 160), 1024, 128, 8)
    table = _f32_table(g, dev, h, w, V)
    if kernel == "B'":
        grids = (_edge_rays(g, dev, _block_grids(g, dev, V, R, S, 0.4)) if case == "edge"
                 else _train_rays(g, dev, R, S, strips=False, V=V))
        fn = lambda t: kb.cosine_prior(t, grids, None, G)
        plain = lambda t: kb.cosine_prior_plain(t, grids, None, G)
    else:
        grids, ut = _strip_grids_taken(g, dev, V, R, S, G, h, w)
        if case == "edge":
            grids = _edge_rays(g, dev, grids)
            ut = kd.bucket_ut(kd.block_union_size_raw(kd.pad_rays(grids), h, w))
            assert ut is not None and kd.takes_f32(ut, S, G, n_views=V), ut
        fn = lambda t: kd.block_cosine_prior(t, grids, None, G, ut)
        plain = lambda t: kd.block_cosine_prior_plain(t, grids, None, G, ut)
    gcot = torch.randn(R, S, G, generator=g, device=dev)
    counter = kb.BWD_COUNTER if kernel == "B'" else kd.BWD_COUNTER
    runs = []
    for f in (fn, fn, plain):
        t = table.clone().requires_grad_()
        before = counter.launches
        f(t).backward(gcot)
        torch.cuda.synchronize()
        assert counter.launches == before + (f is fn)
        runs.append(t.grad)
    assert torch.equal(runs[0], runs[1])
    _grad_close(runs[0], runs[2], 1e-5)


@pytest.mark.parametrize("patches,bf16,local", [(False, True, False), (True, True, False),
                                                (False, False, False), (False, True, True)],
                         ids=["train_bf16", "train_fast_bf16", "train_f32",
                              "train_local_radius"])
def test_training_repeats_itself_on_the_card(dev, patches, bf16, local):
    """3 steps of the configs/train.yaml (B') and train_fast.yaml (D')
    recipes at a tiny shape (tests/test_torch_determinism.py's `run_steps`),
    and of train.yaml with the local-radius sampler (no prior kernel: the
    features gathered by `grid_sample_2d`), run twice on the card: equal
    losses, bit-equal parameters and AdamW moments; the kernels' backward
    ran (no plain version)."""
    from test_torch_determinism import assert_same_trajectory, run_steps
    counter = kd.BWD_COUNTER if patches else kb.BWD_COUNTER
    before = (counter.launches, kb.COUNTER.plain_on_cuda, kd.COUNTER.plain_on_cuda)
    first = run_steps(dev, patches, bf16, local_radius=local)
    assert counter.launches == before[0] + (0 if local else 2 * len(first[0]))
    assert (kb.COUNTER.plain_on_cuda, kd.COUNTER.plain_on_cuda) == before[1:]
    assert_same_trajectory(first, run_steps(dev, patches, bf16, local_radius=local))


@pytest.mark.parametrize("kernel", ["B", "B'", "D", "D'", "E", "F"])
def test_prior_kernels_refuse_other_view_counts(dev, kernel):
    """On CUDA tensors B, B', D, D', E and F at V = 9 (they take up to 8
    views) raise a ValueError that names V; nothing is launched and no plain
    version runs in their place."""
    V = 9
    g = torch.Generator(device=dev).manual_seed(18)
    grids = torch.rand(V, 16, 32, 2, generator=g, device=dev) * 2 - 1
    counters = (kb.COUNTER, kb.BWD_COUNTER, kd.COUNTER, kd.F32_COUNTER, kd.BWD_COUNTER,
                ke.COUNTER, kf.COUNTER)
    before = [(c.launches, c.plain_on_cuda) for c in counters]
    with pytest.raises(ValueError, match=f"V={V} views"):
        if kernel == "E":
            images = torch.randint(0, 256, (V, 20, 24, 3), generator=g, device=dev,
                                   dtype=torch.int32).to(torch.uint8)
            ke.supercell_color_sample(ke.build_supercell_colors(images), grids, 20, 24)
        elif kernel == "F":
            table = torch.randn(V, 20, 24, (V - 1) * 128, generator=g, device=dev)
            taps = [tap_rows_and_weights(table[v], grids[v]) for v in range(V)]
            kf.fused_interp_grouped_cosine(torch.stack([t[0] for t in taps]).contiguous(),
                                           torch.stack([t[1] for t in taps]).contiguous(), 2)
        elif kernel in ("B", "D"):
            table, scales = _int8_table(g, dev, 20, 24, V)
            if kernel == "B":
                kb.cosine_prior(table, grids, scales, 2)
            else:
                kd.block_cosine_prior(table, grids, scales, 2, 128)
        else:
            table = _f32_table(g, dev, 20, 24, V).requires_grad_()
            if kernel == "B'":
                kb.cosine_prior(table, grids, None, 2)
            else:
                kd.block_cosine_prior(table, grids, None, 2, 128)
    torch.cuda.synchronize()
    assert [(c.launches, c.plain_on_cuda) for c in counters] == before


def test_convergence_train_recipe_follows_all_plain(dev):
    """30 steps of `matchnerf_tpu_torch.convergence`'s train recipe (the
    small shape: 32x48, 2 layers, S = 32; A' and B' every step) on the
    kernels and all-plain from one seed: the mean loss of steps 21-30
    within 10 % of the all-plain run's, both below step 1's loss."""
    from matchnerf_tpu_torch import convergence
    runs = {}
    for kernel in (True, False):
        cfg = convergence.recipe_config("train")
        runs[kernel] = convergence.run(cfg, 30, dev, kernel=kernel, seed=0, log=None)
    k, p = runs[True], runs[False]
    assert all(s["launches"]["window_attention_bwd"] > 0
               and s["launches"]["cosine_prior_bwd"] == 2 for s in k["per_step"])
    assert not any(k["plain_on_cuda"].values()), k["plain_on_cuda"]
    mean_k, mean_p = (sum(r["losses"][20:]) / 10 for r in (k, p))
    assert abs(mean_k - mean_p) <= 0.1 * mean_p, (mean_k, mean_p)
    assert mean_k < k["losses"][0] and mean_p < p["losses"][0], (k["losses"], p["losses"])
