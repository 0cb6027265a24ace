"""GMFlow encoder of the PyTorch port vs the JAX `encode`, on the CPU in f32.

Both run from the same JAX PRNG(0) weights (through the weight bridge) on
the same numpy images: 2 transformer layers (the second shifted), 32 x 64
images (1/8 scale 4 x 8, windows of 2 x 4). Tolerance: 2e-5 of each scale's
largest magnitude (features reach ~12 and ~24 here; the measured error is
~4e-6 of that): convolution and matmul sums run in other orders through 15
convolutions, 4 attention layers and the upsampler.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as ge
from matchnerf_tpu.models.matchnerf import encode as jax_encode
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF, encode
from matchnerf_tpu_torch.weights import state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401


def test_encode_per_scale_matches_jax():
    cfg = ge._tiny_cfg(n_layers=2, sample_intvs=16)
    params = jax_init(jax.random.PRNGKey(0), cfg)
    model = MatchNeRF(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (1, 3, 32, 64, 3)).astype(np.float32)
    ref = jax_encode(params, cfg, jnp.asarray(imgs))
    with torch.no_grad():
        got = encode(model, cfg, torch.tensor(imgs))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32
        scale = float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5 * max(scale, 1.0))
