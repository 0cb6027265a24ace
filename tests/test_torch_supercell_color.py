"""Kernel E (supercell colour sample) of the PyTorch port vs the JAX
package, on the CPU.

- `build_supercell_colors` is bit-exact with the JAX table (sizes that are
  not multiples of the supercell, so the edge padding shows).
- `supercell_cells_weights` and `color_union_size` give the JAX integers
  exactly; `bucket_color_ut` the same buckets.
- The plain Kernel E (no union) vs JAX `supercell_color_sample` (Pallas,
  interpret mode, through the union at the fitting bucket): atol 2e-2 on the
  0-255 scale, the JAX test's own bound (tests/test_pallas_color.py:87);
  R = 60 is not a multiple of the 8-ray block.
- The plain Kernel E vs the port's direct gather on the uint8 image: atol
  1e-3 on the 0-255 scale (the same taps and weights, y-then-x association
  instead of four weighted taps: f32 rounding of values <= 255), also on
  grids whose union overflows every bucket.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchnerf_tpu.ops import pallas_color as jpc
from matchnerf_tpu_torch.ops import supercell_color as ke
from matchnerf_tpu_torch.ops.grid_sample import grid_sample_2d
from torch_threads import one_torch_thread  # noqa: F401


def _block_grids(rng, V, R, S, lo=-1.1, hi=1.1):
    """Block-coherent grids with border-clamp cases (|coord| slightly > 1)."""
    base = rng.uniform(lo, hi, (V, (R + 7) // 8, 1, S, 2)).astype(np.float32)
    drift = np.linspace(0, 0.03, 8, dtype=np.float32)[None, None, :, None, None]
    return np.ascontiguousarray((base + drift).reshape(V, -1, S, 2)[:, :R])


def test_build_supercell_colors_bit_exact():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 37, 42, 3), dtype=np.uint8)
    got = ke.build_supercell_colors(torch.tensor(img))
    want = np.asarray(jpc.build_supercell_colors(jnp.asarray(img)))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (2, 10, 11, 80)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cells_and_union_size_match_jax():
    rng = np.random.default_rng(1)
    H, W, R, S = 64, 96, 32, 16
    grids = _block_grids(rng, 3, R, S, -1.2, 1.2)
    got = ke.supercell_cells_weights(torch.tensor(grids), H, W)
    want = jpc._supercell_cells_weights(jnp.asarray(grids), H, W)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n = ke.color_union_size(torch.tensor(grids), H, W)
    assert n == int(jpc.color_union_size(jnp.asarray(grids), H, W))
    assert n == max(len(np.unique(b)) for b in got[0].numpy().reshape(-1, 8 * S))


def test_bucket_color_ut_matches_jax():
    for n in (1, 48, 49, 200, 320, 321):
        assert ke.bucket_color_ut(n) == jpc.bucket_color_ut(n)
    assert ke.COLOR_UT_BUCKETS == jpc.COLOR_UT_BUCKETS


@pytest.mark.parametrize("R", [64, 60])
def test_plain_kernel_e_matches_jax_and_gather(R):
    rng = np.random.default_rng(2)
    V, H, W, S = 3, 48, 78, 16                 # W not a multiple of 4
    img = rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8)
    grids = _block_grids(rng, V, R, S)
    gp = np.concatenate([grids, np.repeat(grids[:, -1:], (-R) % 8, axis=1)], axis=1)
    n = ke.color_union_size(torch.tensor(gp), H, W)
    ut = ke.bucket_color_ut(n)
    assert ut is not None and n == int(jpc.color_union_size(jnp.asarray(gp), H, W))

    tab = ke.build_supercell_colors(torch.tensor(img))
    got = ke.supercell_color_sample(tab, torch.tensor(grids), H, W)
    assert got.shape == (R, S, 3 * V) and got.dtype == torch.float32
    ref = jpc.supercell_color_sample(jpc.build_supercell_colors(jnp.asarray(img))[None],
                                     jnp.asarray(grids)[:, None], H, W, ut=ut)
    ref = np.moveaxis(np.asarray(ref)[:, 0], 0, 2).reshape(R, S, 3 * V)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2, rtol=0)

    np.testing.assert_allclose(got.numpy(), _direct(img, grids).numpy(), atol=1e-3, rtol=0)


def _direct(img, grids):
    """The port's direct gather on the uint8 image, [R,S,3V]."""
    V, R, S = grids.shape[:3]
    return torch.stack([grid_sample_2d(torch.tensor(img[v:v + 1]),
                                       torch.tensor(grids[v:v + 1]))[0]
                        for v in range(V)], dim=2).reshape(R, S, 3 * V)


def test_plain_kernel_e_tiny_union():
    """All samples near the image centre, a few supercells per view: every
    sample reads its own supercell's window, whose four interior taps cover
    the centre pixels."""
    rng = np.random.default_rng(3)
    V, H, W, R, S = 2, 32, 32, 8, 8
    img = rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8)
    grids = rng.uniform(-0.02, 0.02, (V, R, S, 2)).astype(np.float32)
    got = ke.supercell_color_sample(ke.build_supercell_colors(torch.tensor(img)),
                                    torch.tensor(grids), H, W)
    np.testing.assert_allclose(got.numpy(), _direct(img, grids).numpy(), atol=1e-3, rtol=0)


def test_plain_kernel_e_overflowing_union():
    """Samples spread over the whole image, past its border too, R not a
    multiple of 8: the union of an 8-ray block overflows every bucket (the
    route would take the gather), and the union-free plain E still equals
    the direct gather."""
    rng = np.random.default_rng(4)
    V, H, W, R, S = 3, 96, 130, 21, 64
    img = rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8)
    grids = rng.uniform(-1.05, 1.05, (V, R, S, 2)).astype(np.float32)
    gp = np.concatenate([grids, np.repeat(grids[:, -1:], (-R) % 8, axis=1)], axis=1)
    assert ke.bucket_color_ut(ke.color_union_size(torch.tensor(gp), H, W)) is None
    got = ke.supercell_color_sample(ke.build_supercell_colors(torch.tensor(img)),
                                    torch.tensor(grids), H, W)
    assert got.shape == (R, S, 3 * V)
    np.testing.assert_allclose(got.numpy(), _direct(img, grids).numpy(), atol=1e-3, rtol=0)
