"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked `gpu`: each test skips (with the reason) where no CUDA device is
available, as on a CPU-only host. On a GPU machine run them with
`python -m pytest tests/test_torch_kernels_gpu.py -q`; chip_smoke.py
covers the same kernels at the full DTU shapes.
Tolerances: f32 kernels 1e-5 (summation order only), the bf16 window
attention 2e-2 (the plain version rounds P to bf16 before P.V).
"""
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
from matchnerf_tpu_torch.ops import cosine_prior as kb
from matchnerf_tpu_torch.ops import decoder as kc
from matchnerf_tpu_torch.ops import window_attention as ka
from matchnerf_tpu_torch.ops.attention import shift_region_ids

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


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
@pytest.mark.parametrize("G", [2, 8])
def test_cosine_prior_kernel(dev, dtype, G):
    g = torch.Generator(device=dev).manual_seed(1)
    if dtype == torch.int8:
        table = torch.randint(-127, 128, (3, 20, 24, 256), generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
    else:
        table = torch.randn(3, 20, 24, 256, generator=g, device=dev)
    scales = torch.rand(3, 256, generator=g, device=dev) * 0.02 + 1e-3
    grids = torch.rand(3, 37, 48, 2, generator=g, device=dev) * 2.4 - 1.2
    got = kb.cosine_prior(table, grids, scales, G)
    ref = kb.cosine_prior_plain(table, grids, scales, G)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", ["flagship", "demo_own"])
def test_cond_nerf_decode_kernel(dev, variant):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=48)))
    if variant == "demo_own":
        cfg.decoder = DotDict({**cfg.decoder, "raytrans_act": "ELU",
                               "density_maskfill": True, "raytrans_posenc": True})
    model = init_matchnerf(cfg, torch.Generator().manual_seed(2)).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(3)
    B, R, S = 1, 50, 48
    rnd = lambda *s: torch.rand(*s, generator=g, device=dev)
    ray = torch.randn(B, R, 3, generator=g, device=dev)
    unit = (ray / ray.norm(dim=-1, keepdim=True))[:, :, None].expand(B, R, S, 3).contiguous()
    mask = (rnd(B, R, S, 3) > 0.4).float()
    mask[:, :5] = 0.0
    cond = {"feat_info": rnd(B, R, S, 10) * 2 - 1, "color_info": rnd(B, R, S, 9),
            "mask_info": mask}
    depth = torch.sort(rnd(B, R, S) * 2.4 + 2.1, dim=-1).values[..., None].contiguous()
    args = (model.nerf_dec, cfg, rnd(B, R, S, 3) * 2 - 1, unit, cond, depth, ray)
    with torch.no_grad():
        got = kc.cond_nerf_decode(*args)
        ref = kc.cond_nerf_decode_plain(*args)
    for a, b, tol in zip(got, ref, (1e-5, 1e-4, 1e-5)):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)
