"""Ten source views: the plain B and D forwards (atol 2e-5) and the plain
B' and D' table gradients (atol 1e-4, rtol 1e-3, as
tests/test_torch_train_ops.py) at V = 10 against the JAX custom VJPs
`banded_cosine_scale_trainable` (its packed gradient folded onto the
unpacked table) and `block_banded_cosine_scale_trainable` in interpret
mode; tests/test_torch_views_past_eight_paths.py holds the training step
that reaches them."""
import jax
import jax.numpy as jnp
import numpy as np
from test_torch_train_ops import _fold_packed_grad
from test_torch_views import _grids, _packed, _port_grad, _ut

from matchnerf_tpu.models.gmflow.gmflow import pair_index_lists
from matchnerf_tpu.ops import pallas_block_banded as jbb
from matchnerf_tpu.ops.pallas_banded import banded_cosine_scale_trainable
from matchnerf_tpu_torch.ops import block_cosine_prior as kd
from matchnerf_tpu_torch.ops import cosine_prior as kb
from torch_threads import one_torch_thread  # noqa: F401

H, W, C, S, G = 20, 24, 16, 24, 4


def test_plain_prior_grads_match_jax_ten_views():
    """The plain B and D forwards and the plain B' and D' table gradients
    (f32 tables, no scales) at V = 10 against the JAX custom VJPs, on a
    ragged R (13 rays: the block route's tail block repeats the last ray)."""
    V, Rg = 10, 13
    rng = np.random.default_rng(190)
    Cc = (V - 1) * C
    feat = rng.normal(0, 1, (V, H, W, Cc)).astype(np.float32)
    grids = _grids(rng, V, Rg, S, spread=0.3)
    gcot = rng.normal(0, 1, (Rg, S, G)).astype(np.float32)
    pairs = pair_index_lists(V)

    jout, vjp = jax.vjp(lambda vf: banded_cosine_scale_trainable(
        vf, jnp.asarray(grids)[:, None], 48, G, pairs, 8), _packed(feat))
    (jg,) = vjp(jnp.asarray(gcot)[None])
    out, grad_b = _port_grad(lambda t, g: kb.cosine_prior_plain(t, g, None, G),
                             feat, grids, gcot)
    np.testing.assert_allclose(out, np.asarray(jout)[0], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(grad_b, _fold_packed_grad(np.asarray(jg)[0], Cc),
                               atol=1e-4, rtol=1e-3)

    pad = (-Rg) % 8
    gp = np.concatenate([grids, np.repeat(grids[:, -1:], pad, axis=1)], axis=1)
    ut = _ut(grids, H, W)
    jout, vjp = jax.vjp(lambda vf: jbb.block_banded_cosine_scale_trainable(
        vf, jnp.asarray(gp)[:, None], 48, ut, G, pairs, 8), jnp.asarray(feat)[None])
    (jg,) = vjp(jnp.asarray(np.pad(gcot, ((0, pad), (0, 0), (0, 0))))[None])
    out, grad_d = _port_grad(lambda t, g: kd.block_cosine_prior_plain(t, g, None, G, ut),
                             feat, grids, gcot)
    np.testing.assert_allclose(out, np.asarray(jout)[0, :Rg], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(grad_d, np.asarray(jg)[0], atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(grad_d, grad_b, atol=1e-5, rtol=1e-5)
