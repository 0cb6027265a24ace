"""PyTorch port vs the JAX package: camera, posenc, norms, grid sample and
the window-split helpers, on the CPU in f32.

Inputs come from numpy with fixed seeds and go through both packages.
Tolerance atol 1e-6 (relative 1e-6 where values are large): both run f32
on the CPU, so only summation order and libm ulps differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchnerf_tpu import camera as jcam
from matchnerf_tpu.ops import attention as jattn
from matchnerf_tpu.ops import grid_sample as jgs
from matchnerf_tpu.ops import nn as jnn
from matchnerf_tpu.ops import norm as jnorm
from matchnerf_tpu.ops import posenc as jpe
from matchnerf_tpu.ops import resize as jresize
from matchnerf_tpu_torch import camera as tcam
from matchnerf_tpu_torch.ops import attention as tattn
from matchnerf_tpu_torch.ops import grid_sample as tgs
from matchnerf_tpu_torch.ops import nn as tnn
from matchnerf_tpu_torch.ops import norm as tnorm
from matchnerf_tpu_torch.ops import posenc as tpe
from matchnerf_tpu_torch.ops import resize as tresize

ATOL = 1e-6


def close(got, ref, atol=ATOL, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol)


def _poses(rng, n):
    out = []
    for _ in range(n):
        eye = np.array([3.0, 0.0, 0.0]) + rng.normal(0, 0.3, 3)
        z = -eye / np.linalg.norm(eye)
        x = np.cross(z, [0, 1, 0]); x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rm = np.stack([x, y, z], 0)
        out.append(np.concatenate([Rm, (-Rm @ eye)[:, None]], 1))
    return np.stack(out).astype(np.float32)


def test_camera_ray_cast_and_projection():
    rng = np.random.default_rng(0)
    H, W = 12, 20
    w2c = _poses(rng, 2)
    intr = np.array([[[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]]] * 2,
                    np.float32)
    c2w_j = jcam.pose_inverse_legacy_np(w2c)
    c2w_t = tcam.pose_inverse_legacy_np(w2c)
    np.testing.assert_array_equal(c2w_t, c2w_j)
    close(tcam.pose_inverse(torch.tensor(w2c)), jcam.pose_inverse(jnp.asarray(w2c)))

    for legacy in (True, False):
        close(tcam.pixel_grid(H, W, legacy=legacy), jcam.pixel_grid(H, W, legacy=legacy))
    grid = np.asarray(jcam.pixel_grid(H, W, legacy=True))[None].repeat(2, 0)
    cj, rj = jcam.get_center_and_ray(jnp.asarray(grid), jnp.asarray(intr),
                                     jnp.asarray(c2w_j))
    ct, rt = tcam.get_center_and_ray(torch.tensor(grid), torch.tensor(intr),
                                     torch.tensor(c2w_t))
    close(ct, cj)
    close(rt, rj, atol=1e-5)   # inverse of intr: LU in both, ulp-level drift
    depth = np.sort(rng.uniform(2, 4.5, (2, grid.shape[1], 8, 1)), axis=2).astype(np.float32)
    pj = jcam.get_3d_points_from_depth(cj, rj, jnp.asarray(depth), multi_samples=True)
    pt = tcam.get_3d_points_from_depth(torch.tensor(np.asarray(cj)),
                                       torch.tensor(np.asarray(rj)),
                                       torch.tensor(depth), multi_samples=True)
    close(pt, pj)
    inv_scale = np.array([[W - 1, H - 1]] * 2, np.float32)
    nf = np.array([[2.0, 4.5]] * 2, np.float32)
    nj = jcam.get_coord_ref_ndc(jnp.asarray(w2c), jnp.asarray(intr), pj,
                                jnp.asarray(inv_scale), jnp.asarray(nf))
    nt = tcam.get_coord_ref_ndc(torch.tensor(w2c), torch.tensor(intr),
                                torch.tensor(np.asarray(pj)), torch.tensor(inv_scale),
                                torch.tensor(nf))
    close(nt, nj, atol=2e-6)


def test_posenc_variants():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (5, 7, 3)).astype(np.float32)
    close(tpe.nerf_posenc_legacy(torch.tensor(x), 10), jpe.nerf_posenc_legacy(jnp.asarray(x), 10),
          atol=2e-6)
    close(tpe.nerf_posenc(torch.tensor(x), 4), jpe.nerf_posenc(jnp.asarray(x), 4), atol=2e-6)
    close(tpe.sine_position_embedding_2d(4, 6, 64), jpe.sine_position_embedding_2d(4, 6, 64),
          atol=0, rtol=0)
    close(tpe.ray_sinusoid_table(16, 24), jpe.ray_sinusoid_table(16, 24), atol=0, rtol=0)


@pytest.mark.parametrize("shape", [(2, 6, 10, 16), (1, 5, 8, 4)])
def test_instance_and_layer_norm_and_gelu(shape):
    rng = np.random.default_rng(2)
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)             # NHWC
    ref = jnorm.instance_norm_2d(jnp.asarray(x))
    got = tnorm.instance_norm_2d(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, ref, atol=2e-6)
    w = rng.normal(1, 0.1, shape[-1]).astype(np.float32)
    b = rng.normal(0, 0.1, shape[-1]).astype(np.float32)
    for eps in (1e-5, 1e-6):
        close(tnorm.layer_norm(torch.tensor(x), torch.tensor(w), torch.tensor(b), eps),
              jnorm.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps),
              atol=2e-6)
    close(tnn.gelu(torch.tensor(x)), jnn.gelu(jnp.asarray(x)), atol=2e-6)
    close(tnn.leaky_relu(torch.tensor(x)), jnn.leaky_relu(jnp.asarray(x)), atol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8", "uint8"])
def test_grid_sample_and_frustum_mask(dtype):
    rng = np.random.default_rng(3)
    B, H, W, C = 2, 9, 13, 6
    if dtype == "float32":
        feat = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    elif dtype == "int8":
        feat = rng.integers(-127, 128, (B, H, W, C)).astype(np.int8)
    else:
        feat = rng.integers(0, 256, (B, H, W, C)).astype(np.uint8)
    # include points outside [-1,1] (border clamp) and exactly on the edge
    grid = rng.uniform(-1.3, 1.3, (B, 7, 5, 2)).astype(np.float32)
    grid[0, 0, 0] = [1.0, -1.0]
    ref = jgs.grid_sample_2d(jnp.asarray(feat), jnp.asarray(grid))
    got = tgs.grid_sample_2d(torch.tensor(feat), torch.tensor(grid))
    close(got, ref, atol=1e-6 if dtype == "float32" else 1e-4, rtol=1e-6)
    close(tgs.in_frustum_mask(torch.tensor(grid)), jgs.in_frustum_mask(jnp.asarray(grid)),
          atol=0, rtol=0)


def test_resize_and_upsample():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 5, 7, 3)).astype(np.float32)
    close(tresize.resize_bilinear_align_corners(torch.tensor(x), 8, 11),
          jresize.resize_bilinear_align_corners(jnp.asarray(x), 8, 11), atol=2e-6)
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    close(tresize.upsample_bilinear_x2(xt).permute(0, 2, 3, 1),
          jresize.upsample_bilinear_x2(jnp.asarray(x)), atol=2e-6)
    close(tresize.upsample_nearest_x2(xt).permute(0, 2, 3, 1),
          jresize.upsample_nearest_x2(jnp.asarray(x)), atol=0)


@pytest.mark.parametrize("hw,splits", [((8, 12), 2), ((12, 12), 3)])
def test_window_split_helpers(hw, splits):
    rng = np.random.default_rng(5)
    h, w = hw
    x = rng.normal(0, 1, (2, h, w, 4)).astype(np.float32)
    sj = jattn.split_feature(jnp.asarray(x), splits)
    st = tattn.split_feature(torch.tensor(x), splits)
    close(st, sj, atol=0)
    close(tattn.merge_splits(st, splits), x, atol=0)
    wh, ww = h // splits, w // splits
    ids_j = jattn.window_region_ids(h, w, wh, ww, wh // 2, ww // 2)
    np.testing.assert_array_equal(tattn.window_region_ids(h, w, wh, ww, wh // 2, ww // 2), ids_j)
    np.testing.assert_array_equal(tattn.shift_region_ids(h, w, splits).numpy(),
                                  ids_j.astype(np.int32))
    close(tattn.generate_shift_window_attn_mask(h, w, wh, ww, wh // 2, ww // 2),
          jattn.generate_shift_window_attn_mask(h, w, wh, ww, wh // 2, ww // 2), atol=0)
