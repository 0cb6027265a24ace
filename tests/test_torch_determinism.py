"""Reproducibility of the port's training step, the twin of
tests/test_determinism.py::test_same_seed_same_training_trajectory: one
seed gives one trajectory. Two runs of 3 steps from the same weights, the
same numpy inputs (`__graft_entry__._synthetic_inputs`, seed 0) and the
same seeded ray and depth draws give equal losses and bit-equal parameters
and AdamW moments, for configs/train.yaml's rays (Kernel B' on the card)
and configs/train_fast.yaml's 8-pixel strips (D'), at the f32 and bf16
policies. Here on the CPU, on one thread and on three;
tests/test_torch_kernels_gpu.py runs `run_steps` on the card, where the
prior kernels' and the upsampler's backward sum in a fixed order.

The upsampler's backward on the card (`ops.resize._BilinearX2`, two
separable transposes in place of CUDA's atomic upsample_bilinear2d_backward)
is held here to torch's own backward of F.interpolate at 2e-6.
"""
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch.engine import Coach
from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
from matchnerf_tpu_torch.ops import resize
from torch_threads import one_torch_thread  # noqa: F401

H, W, N_RAYS, S, STEPS = 32, 32, 32, 16, 3


def _cfg(patches: bool, bf16: bool, local_radius: bool = False):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=S)))
    if local_radius:
        cfg.encoder = DotDict({**cfg.encoder, "feature_sample_local_radius": 1,
                               "feature_sample_local_dilation": 2})
    cfg.nerf = DotDict({**cfg.nerf, "rand_rays_train": N_RAYS, "train_ray_patches": patches})
    dt = "bfloat16" if bf16 else "float32"
    cfg.precision = DotDict({"encoder_compute_dtype": dt, "decoder_compute_dtype": dt,
                             "banded_kernel": True, "block_kernel": True})
    cfg.data_train = DotDict({"img_wh": [W, H]})
    cfg.freq = DotDict({"scalar": 1})
    cfg.seed = 0
    return cfg


def run_steps(device, patches: bool, bf16: bool, steps: int = STEPS,
              local_radius: bool = False):
    """`steps` training steps from seeded weights on the synthetic scene of
    seed 0 (with `local_radius`, encoder.feature_sample_local_radius 1 at
    dilation 2: no tables, the features gathered per window offset) ->
    (losses, {parameter: tensor}, {parameter: AdamW state}, the route of
    the step: None for B' at both scales, per-scale buckets for D')."""
    cfg = _cfg(patches, bf16, local_radius)
    d = ge._synthetic_inputs(cfg, 1, H, W, R=N_RAYS, seed=0)
    batch_np = {"images": d["images"], "extrinsics": d["poses"], "intrinsics": d["intr"],
                "near_fars": d["near_fars"]}
    model = init_matchnerf(cfg, torch.Generator().manual_seed(3)).to(device)
    coach = Coach(cfg, model, device)
    coach.setup_optimizer(50)
    batch = coach.batch_tensors(batch_np)
    route = coach.train_route(batch_np)
    losses = [float(coach.step(batch, route)["all"]) for _ in range(steps)]
    names = {id(p): n for n, p in model.named_parameters()}
    state = {names[id(p)]: {k: v.detach().clone() for k, v in s.items()}
             for p, s in coach.opt.opt.state.items()}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses, params, state, route


def assert_same_trajectory(a, b):
    """Two `run_steps` results: equal losses, bit-equal parameters and
    optimizer state."""
    (la, pa, sa, _), (lb, pb, sb, _) = a, b
    assert la == lb
    assert pa.keys() == pb.keys() and sa.keys() == sb.keys()
    differ = [n for n in pa if not torch.equal(pa[n], pb[n])]
    assert not differ, f"parameters differ: {differ[:8]}"
    for n in sa:
        for k in sa[n]:
            assert torch.equal(sa[n][k], sb[n][k]), (n, k)


@pytest.mark.parametrize("patches,bf16,threads,local", [
    (False, False, 1, False), (False, True, 1, False), (True, True, 1, False),
    (False, True, 3, False), (True, True, 3, False), (False, True, 3, True)],
    ids=["train_f32", "train_bf16", "train_fast_bf16", "train_bf16_3_threads",
         "train_fast_bf16_3_threads", "train_local_radius_3_threads"])
def test_same_seed_same_training_trajectory(patches, bf16, threads, local):
    """Also on several CPU threads: the plain twins gather rows by
    `grid_sample.take_rows` and the encoder stacks its pairs from slices,
    whose backward sums in a fixed order (that of advanced indexing does not
    on the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        first = run_steps("cpu", patches, bf16, local_radius=local)
        assert (first[3] is None) != patches
        assert len(first[2]) == len(first[1])       # every parameter has its moments
        assert_same_trajectory(first, run_steps("cpu", patches, bf16, local_radius=local))
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 4, 8, 8), (1, 2, 1, 3)])
def test_bilinear_x2_backward_matches_autograd(shape):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(*shape, generator=g, dtype=torch.float64, requires_grad=True)
    y = torch.nn.functional.interpolate(x, scale_factor=2, mode="bilinear",
                                        align_corners=False)
    cot = torch.randn(y.shape, generator=g, dtype=torch.float64)
    ref = torch.autograd.grad(y, x, cot)[0]
    x32 = x.detach().float().requires_grad_()
    out = resize._BilinearX2.apply(x32)
    torch.testing.assert_close(out, y.detach().float(), rtol=0, atol=1e-6)
    out.backward(cot.float())
    torch.testing.assert_close(x32.grad.double(), ref, rtol=0, atol=2e-6)
