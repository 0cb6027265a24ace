"""The port's ops/flow_geometry.py against matchnerf_tpu/ops/flow_geometry.py
on the CPU in f32, at odd sizes: the pixel grid (exact), the window grid
and coordinate normalisation (1e-6), bilinear sampling with 'zeros' and
'border' padding and its mask, flow warping and the forward/backward
occlusion check (1e-5; the masks equal), and InputPadder in 'sintel' and
bottom mode (exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchnerf_tpu.ops import flow_geometry as jfg
from matchnerf_tpu_torch.ops import flow_geometry as fg


def test_coords_grid():
    for hom in (False, True):
        got = fg.coords_grid(2, 5, 7, homogeneous=hom).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfg.coords_grid(2, 5, 7, hom)))


def test_window_grid_and_normalize():
    got = fg.generate_window_grid(-2, 2, -3, 3, 5, 7).numpy()
    np.testing.assert_allclose(got, np.asarray(jfg.generate_window_grid(-2, 2, -3, 3, 5, 7)),
                               atol=1e-6)
    coords = np.random.default_rng(0).uniform(0, 10, (2, 5, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(fg.normalize_coords(torch.tensor(coords), 5, 7).numpy(),
                               np.asarray(jfg.normalize_coords(jnp.asarray(coords), 5, 7)),
                               atol=1e-6)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_bilinear_sample_and_flow_warp(padding_mode):
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    coords = rng.uniform(-2, 11, (2, 7, 9, 2)).astype(np.float32)
    got, mask = fg.bilinear_sample(torch.tensor(feat), torch.tensor(coords), padding_mode,
                                   return_mask=True)
    want, jmask = jfg.bilinear_sample(jnp.asarray(feat), jnp.asarray(coords), padding_mode,
                                      return_mask=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    flow = rng.normal(0, 2, (2, 7, 9, 2)).astype(np.float32)
    got = fg.flow_warp(torch.tensor(feat), torch.tensor(flow), padding_mode=padding_mode)
    want = jfg.flow_warp(jnp.asarray(feat), jnp.asarray(flow), padding_mode=padding_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_forward_backward_consistency():
    rng = np.random.default_rng(2)
    fwd = rng.normal(0, 1.5, (2, 9, 11, 2)).astype(np.float32)
    bwd = (-fwd + rng.normal(0, 0.6, fwd.shape)).astype(np.float32)
    got = fg.forward_backward_consistency_check(torch.tensor(fwd), torch.tensor(bwd))
    want = jfg.forward_backward_consistency_check(jnp.asarray(fwd), jnp.asarray(bwd))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0.0 < float(got[0].mean()) < 1.0


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("hw", [(13, 21), (16, 24), (7, 9)])
def test_input_padder(mode, hw):
    x = np.random.default_rng(3).normal(size=(2, *hw, 3)).astype(np.float32)
    tp, jp = fg.InputPadder(x.shape, mode=mode), jfg.InputPadder(x.shape, mode=mode)
    assert tp._pad == jp._pad
    got, = tp.pad(torch.tensor(x))
    want, = jp.pad(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape[1] % 8 == 0 and got.shape[2] % 8 == 0
    np.testing.assert_array_equal(tp.unpad(got).numpy(), x)
