"""Sixteen source views at a bucket Kernel D took only once it had the pair
layout: the plain Kernel D, which the card holds the kernel to, against the
JAX block-banded kernel (Pallas, interpret mode) at V = 16, S = 128 and
union bucket 512 on int8 tables (atol 1e-2, the JAX kernel's bf16 stencil
weights) and against the port's plain Kernel B (atol 1e-5). At these
(V, S, ut) the route sends the DTU scales' int8 tables to Kernel D; before
the pair layout it sent them to Kernel B. A file of its own: tracing the
JAX kernel's 120 pairs takes most of its time."""
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_views import _int8_table

from matchnerf_tpu.models.gmflow.gmflow import pair_index_lists
from matchnerf_tpu.ops import pallas_block_banded as jbb
from matchnerf_tpu_torch.ops import block_cosine_prior as kd
from matchnerf_tpu_torch.ops import cosine_prior as kb
from torch_threads import one_torch_thread  # noqa: F401

V, H, W, C, R, S, G = 16, 32, 40, 16, 13, 128, 2


def test_plain_kernel_d_sixteen_views_at_a_bucket_the_pair_layout_takes():
    """R = 13 rays (a ragged tail block) in all directions, clamped at the
    border, with unions of 385 to 512 cells."""
    for h, w in ((64, 80), (128, 160)):
        table = torch.empty(V, h, w, (V - 1) * 128, dtype=torch.int8, device="meta")
        assert kd.takes_table(table, torch.ones(1), 512, S, G)
        assert kd.plan(512, S, G, False, 2, h * w, V).pair
        assert kd.channels_per_pass(512, S, G, False, 2, h * w, V) is None
    rng = np.random.default_rng(260)
    starts = rng.uniform(-0.9, 0.9, (V, 2, 1, 2)) + rng.normal(0, 0.01, (V, 2, 8, 2))
    starts = starts.reshape(V, 16, 2)[:, :R]
    ends = starts + rng.uniform(1.2, 1.8, (V, R, 2)) * rng.choice([-1, 1], (V, R, 2))
    t = np.linspace(0, 1, S)[None, None, :, None]
    grids = (starts[:, :, None] * (1 - t) + ends[:, :, None] * t).astype(np.float32)
    feat = rng.normal(0, 1, (V, H, W, (V - 1) * C)).astype(np.float32)
    q, scale = _int8_table(feat)
    ut = kd.bucket_ut(kd.block_union_size_raw(kd.pad_rays(torch.tensor(grids)), H, W))
    assert ut == 512, ut
    pad = np.concatenate([grids, np.repeat(grids[:, -1:], 16 - R, axis=1)], axis=1)
    ref = np.asarray(jbb.block_banded_cosine_scale(
        jnp.asarray(q)[None], jnp.asarray(pad)[:, None], kt=S, ut=ut, n_groups=G,
        pairs=pair_index_lists(V), dequant_scales=jnp.asarray(scale)[None]))[0, :R]
    args = (torch.tensor(q), torch.tensor(grids), torch.tensor(scale), G)
    got = kd.block_cosine_prior(*args, ut)
    assert got.shape == (R, S, G)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-2, rtol=0)
    np.testing.assert_allclose(got.numpy(), kb.cosine_prior(*args).numpy(), atol=1e-5, rtol=0)
