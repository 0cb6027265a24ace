"""Kernel A (window attention) of the PyTorch port vs the JAX package.

The port's `split_window_attention` (roll + split in torch, then the plain
window attention on the CPU) is held against the JAX XLA path
`split_window_attention` and the Pallas flash kernel
`flash_window_attention(interpret=True)`, with and without the shift.
Windows have L = 8 x 16 = 128 tokens and C = 128, so the flash kernel
engages instead of its L < 128 XLA fallback. Tolerance atol 2e-5, as
tests/test_pallas_attention.py uses for the flash kernel (online-softmax
reassociation). The CUDA kernel itself is compared with the plain version
on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchnerf_tpu.ops import attention as jattn
from matchnerf_tpu.ops.pallas_attention import flash_window_attention
from matchnerf_tpu_torch.ops import attention as tattn
from matchnerf_tpu_torch.ops import window_attention as twa

B, H, W, C, SPLITS = 2, 16, 32, 128, 2


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("with_shift", [False, True])
def test_plain_window_attention_matches_jax(with_shift):
    q, k, v = _inputs(0)
    mask = jattn.generate_shift_window_attn_mask(H, W, H // 2, W // 2, H // 4, W // 4)
    ref_xla = jattn.split_window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           num_splits=SPLITS, with_shift=with_shift,
                                           attn_mask=mask)
    ref_flash = flash_window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       num_splits=SPLITS, with_shift=with_shift,
                                       attn_mask=mask, interpret=True)
    rid = tattn.shift_region_ids(H, W, SPLITS)
    before = twa.COUNTER.launches
    got = tattn.split_window_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                       SPLITS, with_shift, region_ids=rid)
    assert twa.COUNTER.launches == before       # CPU tensors take the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_xla), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_flash), atol=2e-5)


def test_window_attention_plain_masks_across_regions():
    """A key in another region gets -100 after scaling: with a huge key
    only in a foreign region, the output must ignore it."""
    L = 8
    rid = torch.tensor([[0, 0, 0, 0, 1, 1, 1, 1]], dtype=torch.int32)
    q = torch.zeros(1, L, 128)
    k = torch.zeros(1, L, 128)
    v = torch.arange(L, dtype=torch.float32)[None, :, None].expand(1, L, 128).contiguous()
    out = twa.window_attention(q, k, v, rid)
    torch.testing.assert_close(out[0, :4, 0], torch.full((4,), 1.5), atol=1e-6, rtol=0)
    torch.testing.assert_close(out[0, 4:, 0], torch.full((4,), 5.5), atol=1e-6, rtol=0)


def test_window_attention_rejects_unsupported_devices():
    q = torch.zeros(1, 4, 128, device="meta")
    with pytest.raises(ValueError):
        twa.window_attention(q, q, q)
