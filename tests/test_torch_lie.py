"""The port's lie.py against matchnerf_tpu/lie.py on the CPU in f32, on
seeded inputs: rotation vectors of every size including angles near 0 (the
Taylor series' home ground) and near pi (where SO3_to_so3 clips the
arccos), twists, rotation matrices, quaternions. Both run the same
arithmetic in f32 in the same order; tolerances 2e-6. The logarithms
divide by sin(theta) / theta: within 0.05 of pi one ulp of arccos (2.4e-7,
the two libraries' arccos may differ by it) moves the result by 2.4e-7 /
(pi - theta) relative, so there they are held at rtol 1e-3 (measured
2e-4 at pi - 1e-3), elsewhere at 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchnerf_tpu import lie as jlie
from matchnerf_tpu_torch import lie


def _rotvecs(seed=0):
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(40, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = np.concatenate([[0.0, 1e-8, 1e-6, 1e-4, 1e-2], rng.uniform(0.05, 3.0, 25),
                             [np.pi - 1e-3, np.pi - 1e-2, 3.1, 3.13, 3.0, 2.9, 2.5, 1.5,
                              0.7, 0.3]])
    return (axes * angles[:, None]).astype(np.float32)


def _both(fn_name, *arrays):
    j = getattr(jlie, fn_name)(*[jnp.asarray(a) for a in arrays])
    t = getattr(lie, fn_name)(*[torch.tensor(a) for a in arrays])
    return t.numpy(), np.asarray(j)


@pytest.mark.parametrize("fn", ["skew_symmetric", "so3_to_SO3"])
def test_rotation_vector_maps(fn):
    got, want = _both(fn, _rotvecs())
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_taylor_series_near_zero():
    x = torch.tensor([0.0, 1e-8, 1e-5, 1e-3, 0.1, 1.0, 3.0], dtype=torch.float32)
    for name in ("_taylor_A", "_taylor_B", "_taylor_C"):
        got = getattr(lie, name)(x).numpy()
        want = np.asarray(getattr(jlie, name)(jnp.asarray(x.numpy())))
        np.testing.assert_allclose(got, want, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(lie._taylor_A(x[4:]).numpy(), np.sin(x[4:].numpy()) /
                               x[4:].numpy(), atol=1e-6)


def test_log_maps_and_twists():
    w = _rotvecs(1)
    near_pi = np.linalg.norm(w, axis=-1) > np.pi - 0.05
    assert near_pi.sum() >= 3
    R = lie.so3_to_SO3(torch.tensor(w)).numpy()
    got, want = _both("SO3_to_so3", R)
    np.testing.assert_allclose(got[~near_pi], want[~near_pi], atol=1e-5)
    np.testing.assert_allclose(got[near_pi], want[near_pi], rtol=1e-3, atol=1e-5)
    rng = np.random.default_rng(2)
    wu = np.concatenate([w, rng.normal(size=(len(w), 3)).astype(np.float32)], axis=-1)
    got, want = _both("se3_to_SE3", wu)
    np.testing.assert_allclose(got, want, atol=2e-6)
    got_inv, want_inv = _both("SE3_to_se3", want)
    np.testing.assert_allclose(got_inv[~near_pi], want_inv[~near_pi], atol=1e-5)
    np.testing.assert_allclose(got_inv[near_pi], want_inv[near_pi], rtol=1e-3, atol=1e-5)
    # away from pi the log inverts the exponential
    small = np.linalg.norm(w, axis=-1) < 2.5
    np.testing.assert_allclose(got_inv[small], wu[small], atol=1e-3)


def test_quaternions():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(30, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [1, 0, 0, 0]
    for name, args in (("q_to_R", (q,)), ("q_invert", (q * 1.7,)),
                       ("q_product", (q, q[::-1].copy()))):
        got, want = _both(name, *args)
        np.testing.assert_allclose(got, want, atol=2e-6, err_msg=name)
    R = lie.q_to_R(torch.tensor(q)).numpy()
    got, want = _both("R_to_q", R)
    np.testing.assert_allclose(got, want, atol=2e-6)
