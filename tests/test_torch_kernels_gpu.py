"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked `gpu`: each test skips (with the reason) where no CUDA device is
available, as on a CPU-only host. On a GPU machine run them with
`python -m pytest tests/test_torch_kernels_gpu.py -q`; chip_smoke.py
covers the same kernels at the full DTU shapes.
Tolerances: f32 kernels 1e-5 (summation order only), the bf16 window
attention 2e-2 (the plain version rounds the normalised P to bf16 before
P.V, the kernel the unnormalised one), both also at the DTU shape
[24,1280,128] (f32 on split-TF32 tensor cores: 1e-5 still holds);
the forward's logsumexp against torch.logsumexp of the plain masked scores,
1e-3 for f32 and 2e-2 for bf16 inputs, at L = 160 (a ragged last key tile)
and L = 1280. The block-union cosine prior (D) runs at small shapes, at the
largest union it takes (512 rows: the most dynamic shared memory), and with
a ragged R and samples on the border, on int8 tables and on bf16 tables;
the cosine prior (B) on int8, bf16 and f32 tables. The supercell colour sample (E) reads
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
an activation now and then); S above the kernel's limit raises.

The fused interp + grouped cosine (F) on tap rows of int8, bf16 and f32,
with and without dequantisation scales, at G = 2 and 8 and a ragged N:
1e-5 (summation order; on int8 rows gathered from a table also against
Kernel B, the same function by another route).

The training kernels against autograd through the plain versions: A'
(window attention backward; f32 1e-4 and bf16 3e-2 of the largest
gradient, the plain backward rounding dA and A to bf16 where the kernel
keeps f32; both types also at the training shape [24,1280,128], at a
ragged L = 100 and with fewer region rows than windows, and bit-equal
from run to run), B' (cosine-prior table gradient, atomics in any order:
1e-5 of the largest gradient) and D' (f32 block forward 1e-5, and its table
gradient 1e-5 of the largest, also against B', the same function).
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


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [2, 8])
def test_cosine_prior_kernel(dev, dtype, G):
    g = torch.Generator(device=dev).manual_seed(1)
    if dtype == torch.int8:
        table = torch.randint(-127, 128, (3, 20, 24, 256), generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
    else:
        table = torch.randn(3, 20, 24, 256, generator=g, device=dev).to(dtype)
    scales = torch.rand(3, 256, generator=g, device=dev) * 0.02 + 1e-3
    grids = torch.rand(3, 37, 48, 2, generator=g, device=dev) * 2.4 - 1.2
    got = kb.cosine_prior(table, grids, scales, G)
    ref = kb.cosine_prior_plain(table, grids, scales, G)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def _decode_args(dev, variant, R, S):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=S)))
    if variant == "demo_own":
        cfg.decoder = DotDict({**cfg.decoder, "raytrans_act": "ELU",
                               "density_maskfill": True, "raytrans_posenc": True})
    model = init_matchnerf(cfg, torch.Generator().manual_seed(2)).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(3)
    B = 1
    rnd = lambda *s: torch.rand(*s, generator=g, device=dev)
    ray = torch.randn(B, R, 3, generator=g, device=dev)
    unit = (ray / ray.norm(dim=-1, keepdim=True))[:, :, None].expand(B, R, S, 3).contiguous()
    mask = (rnd(B, R, S, 3) > 0.4).float()
    mask[:, :5] = 0.0
    cond = {"feat_info": rnd(B, R, S, 10) * 2 - 1, "color_info": rnd(B, R, S, 9),
            "mask_info": mask}
    depth = torch.sort(rnd(B, R, S) * 2.4 + 2.1, dim=-1).values[..., None].contiguous()
    return (model.nerf_dec, cfg, rnd(B, R, S, 3) * 2 - 1, unit, cond, depth, ray)


@pytest.mark.parametrize("variant", ["flagship", "demo_own"])
def test_cond_nerf_decode_kernel(dev, variant):
    args = _decode_args(dev, variant, 50, 48)
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


def test_cond_nerf_decode_kernel_sample_limit(dev):
    args = _decode_args(dev, "flagship", 3, kc.S_MAX + 1)
    with torch.no_grad(), pytest.raises(ValueError, match=f"S <= {kc.S_MAX}"):
        kc.cond_nerf_decode(*args)


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


def _int8_table(g, dev, h, w):
    table = torch.randint(-127, 128, (3, h, w, 256), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
    scales = torch.rand(3, 256, generator=g, device=dev) * 0.02 + 1e-3
    return table, scales


@pytest.mark.parametrize("G", [2, 8])
@pytest.mark.parametrize("case", ["small", "cap_512", "ragged_border"])
def test_block_cosine_prior_kernel(dev, case, G):
    g = torch.Generator(device=dev).manual_seed(4)
    if case == "small":
        table, scales = _int8_table(g, dev, 20, 24)
        grids = _block_grids(g, dev, 3, 40, 48, 0.3)
    elif case == "cap_512":
        # random cells in a wide table: ~4 x 8 x 15 dilated rows per block
        table, scales = _int8_table(g, dev, 64, 80)
        grids = torch.rand(3, 16, 15, 2, generator=g, device=dev) * 2 - 1
    else:
        table, scales = _int8_table(g, dev, 16, 16)
        grids = _block_grids(g, dev, 3, 13, 32, 0.5)
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


@pytest.mark.parametrize("G", [2, 8])
@pytest.mark.parametrize("case", ["small", "cap_512", "ragged_border"])
def test_block_cosine_prior_bf16_kernel(dev, case, G):
    """Kernel D on bf16 tables (no scales): the staged-pass kernel at
    CP = 128 or, for ut 512, 64 channels a pass; against its plain version
    and Kernel B's bf16 form."""
    g = torch.Generator(device=dev).manual_seed(5)
    h, w = {"small": (20, 24), "cap_512": (64, 80), "ragged_border": (16, 16)}[case]
    table = torch.randn(3, h, w, 256, generator=g, device=dev).to(torch.bfloat16)
    if case == "small":
        grids = _block_grids(g, dev, 3, 40, 48, 0.3)
    elif case == "cap_512":
        grids = torch.rand(3, 16, 15, 2, generator=g, device=dev) * 2 - 1
    else:
        grids = _block_grids(g, dev, 3, 13, 32, 0.5)
        grids[:, :, :4] = torch.clamp(grids[:, :, :4] * 3.0, -1.0, 1.0)
        grids[:, -1, -2:] = 1.0
    ut = kd.bucket_ut(kd.block_union_size_raw(kd.pad_rays(grids), h, w))
    assert kd.takes_bf16(ut, grids.shape[2], G)
    before = kd.COUNTER.by_entry.get("block_cosine_prior_bf16", 0)
    got = kd.block_cosine_prior(table, grids, None, G, ut)
    torch.cuda.synchronize()
    assert kd.COUNTER.by_entry["block_cosine_prior_bf16"] == before + 1
    ref = kd.block_cosine_prior_plain(table, grids, None, G, ut)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    if case != "cap_512":
        torch.testing.assert_close(got, kb.cosine_prior(table, grids, None, G),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["small", "cap_320", "ragged_border", "overflow"])
def test_supercell_color_kernel(dev, case):
    g = torch.Generator(device=dev).manual_seed(5)
    V, img_h, img_w = 3, 50, 66
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


def _f32_table(g, dev, h, w):
    return torch.randn(3, h, w, 256, generator=g, device=dev)


@pytest.mark.parametrize("G", [2, 8])
def test_cosine_prior_backward_kernel(dev, G):
    g = torch.Generator(device=dev).manual_seed(7)
    table = _f32_table(g, dev, 20, 24)
    grids = _block_grids(g, dev, 3, 37, 48, 0.4)
    grids[:, :3, :4] = torch.clamp(grids[:, :3, :4] * 3.0, -1.0, 1.0)
    gcot = torch.randn(37, 48, G, generator=g, device=dev)
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


@pytest.mark.parametrize("G,case", [(2, "small"), (8, "small"), (2, "ragged_border"),
                                    (8, "ut_320")])
def test_block_cosine_prior_f32_kernels(dev, G, case):
    g = torch.Generator(device=dev).manual_seed(8)
    if case == "ut_320":
        # wide segments in a 64 x 80 table at S = 128: the widest union D'
        # stages at G = 8 (bucket 256 or 320, 32-channel backward passes)
        table = _f32_table(g, dev, 64, 80)
        for spread in (1.2, 1.0, 0.8, 0.6, 0.5, 0.4):
            grids = _block_grids(g, dev, 3, 24, 128, spread)
            if kd.block_union_size_raw(kd.pad_rays(grids), 64, 80) <= 320:
                break
    elif case == "small":
        table = _f32_table(g, dev, 20, 24)
        grids = _block_grids(g, dev, 3, 40, 48, 0.3)
    else:
        table = _f32_table(g, dev, 16, 16)
        grids = _block_grids(g, dev, 3, 13, 32, 0.5)
        grids[:, :, :4] = torch.clamp(grids[:, :, :4] * 3.0, -1.0, 1.0)
        grids[:, -1, -2:] = 1.0
    h, w = table.shape[1:3]
    R, S = grids.shape[1:3]
    ut = kd.bucket_ut(kd.block_union_size_raw(kd.pad_rays(grids), h, w))
    assert kd.takes_f32(ut, S, G), (ut, S, G)
    if case == "ut_320":
        assert ut >= 192, ut
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
    for i in (1, 2):                # vs the plain twin, and vs Kernels B and B'
        torch.testing.assert_close(outs[0], outs[i], atol=1e-5, rtol=0)
        _grad_close(grads[0], grads[i], 1e-5)
