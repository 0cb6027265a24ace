"""The port's generic NeRF decoder (models/decoder/nerf.py) against JAX
`init_nerf` / `apply_nerf` on the CPU in f32: the weight bridge
(`nerf_state_dict_from_jax`, strict) and the layer shapes, the forward in
eval mode for each density activation and without view dependence, and in
train mode with the density noise, fed JAX's own normal draw. Tolerance
2e-5 (the JAX package's own oracle tolerance for this decoder, 5 layers of
f32 sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.models.decoder.nerf import apply_nerf as jax_apply
from matchnerf_tpu.models.decoder.nerf import init_nerf as jax_init
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch.models.decoder.nerf import NeRF, apply_nerf
from matchnerf_tpu_torch.ops.nn import reset_parameters
from matchnerf_tpu_torch.weights import nerf_state_dict_from_jax


def _cfg(view_dep=True, activ="relu_", noise=None):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1)))
    cfg.decoder = DotDict(dict(cfg.decoder, layers_feat=[None, 32, 32, 32, 32],
                               layers_rgb=[None, 16, 3], skip=[2], density_activ=activ,
                               posenc=DotDict({"L_3D": 10, "L_view": 4})))
    cfg.nerf = DotDict(dict(cfg.nerf, view_dep=view_dep, legacy_coord=False,
                            density_noise_reg=noise))
    return cfg


def _both(cfg, seed=0):
    params = jax_init(jax.random.PRNGKey(seed), cfg)
    # non-zero biases, so that each one's place shows
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jnp.asarray(rng.normal(size=x.shape), x.dtype)
        if x.ndim == 1 else x, params)
    model = NeRF(cfg)
    model.load_state_dict(nerf_state_dict_from_jax(params), strict=True)
    pts = rng.uniform(-1, 1, (2, 5, 7, 3)).astype(np.float32)
    ray = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    return params, model, pts, ray


def test_bridge_and_shapes():
    cfg = _cfg()
    params, model, _, _ = _both(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["mlp_feat.0.weight"] == (32, 63)
    assert shapes["mlp_feat.2.weight"] == (32, 32 + 63)      # skip at layer 2
    assert shapes["mlp_feat.3.weight"] == (33, 32)           # +1 density channel
    assert shapes["mlp_rgb.0.weight"] == (16, 32 + 27)       # feature + view posenc (L=4)
    assert shapes["mlp_rgb.1.weight"] == (3, 16)
    assert len(shapes) == 2 * (4 + 2)
    seeded = reset_parameters(NeRF(cfg), torch.Generator().manual_seed(0))
    for k, v in seeded.state_dict().items():
        assert tuple(v.shape) == shapes[k]
        if k.endswith("bias"):
            assert not v.any()
    # TF Xavier: gain sqrt(2) before a ReLU, 1 on the output layers
    w = seeded.mlp_feat[0].weight.detach()
    assert float(w.abs().max()) <= np.sqrt(2.0) * np.sqrt(6.0 / (63 + 32)) + 1e-6
    assert float(seeded.mlp_feat[3].weight.detach().abs().max()) <= np.sqrt(6.0 / 65) + 1e-6
    no_view = NeRF(_cfg(view_dep=False))
    assert tuple(no_view.mlp_rgb[0].weight.shape) == (16, 32)


@pytest.mark.parametrize("activ", ["relu_", "softplus", "abs", "sigmoid_", "exp"])
def test_eval_matches_jax(activ):
    cfg = _cfg(activ=activ)
    params, model, pts, ray = _both(cfg, seed=1)
    rgb_j, den_j = jax_apply(params, cfg, jnp.asarray(pts), ray_unit=jnp.asarray(ray))
    with torch.no_grad():
        rgb, den = apply_nerf(model, cfg, torch.tensor(pts), torch.tensor(ray))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=2e-5)
    np.testing.assert_allclose(den.numpy(), np.asarray(den_j), atol=2e-5)


def test_without_view_dependence_matches_jax():
    cfg = _cfg(view_dep=False)
    params, model, pts, _ = _both(cfg, seed=2)
    rgb_j, den_j = jax_apply(params, cfg, jnp.asarray(pts))
    with torch.no_grad():
        rgb, den = apply_nerf(model, cfg, torch.tensor(pts))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=2e-5)
    np.testing.assert_allclose(den.numpy(), np.asarray(den_j), atol=2e-5)


def test_train_mode_noise():
    """density_noise_reg in train mode: with JAX's draw fed in, the port
    matches JAX; its own draw comes from the generator (reproducible) and
    eval mode draws none."""
    cfg = _cfg(noise=1.0)
    params, model, pts, ray = _both(cfg, seed=3)
    key = jax.random.PRNGKey(7)
    rgb_j, den_j = jax_apply(params, cfg, jnp.asarray(pts), ray_unit=jnp.asarray(ray),
                             rng=key, mode="train")
    draw = np.asarray(jax.random.normal(key, pts.shape[:-1]))
    t = (torch.tensor(pts), torch.tensor(ray))
    with torch.no_grad():
        rgb, den = apply_nerf(model, cfg, *t, mode="train", noise=torch.tensor(draw))
        clean = apply_nerf(model, cfg, *t, mode="eval")[1]
        a = apply_nerf(model, cfg, *t, mode="train",
                       generator=torch.Generator().manual_seed(5))[1]
        b = apply_nerf(model, cfg, *t, mode="train",
                       generator=torch.Generator().manual_seed(5))[1]
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=2e-5)
    np.testing.assert_allclose(den.numpy(), np.asarray(den_j), atol=2e-5)
    assert not np.allclose(den.numpy(), clean.numpy())
    assert torch.equal(a, b) and not torch.equal(a, clean)
