"""Weight bridge of the PyTorch port: JAX pytree -> port state_dict -> JAX.

JAX `init_matchnerf(PRNGKey(0))` params go through
`matchnerf_tpu_torch.weights.state_dict_from_jax`, load strictly into the
port's MatchNeRF, come back out as its state_dict and through the JAX
package's own `import_matchnerf_checkpoint`: the pytree must come back bit
for bit (tolerance 0: the bridge only transposes and renames).
"""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.import_torch import import_matchnerf_checkpoint
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init_matchnerf
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF, init_matchnerf
from matchnerf_tpu_torch.weights import state_dict_from_jax


@pytest.mark.parametrize("n_layers", [1, 2])
def test_weight_bridge_round_trip_is_exact(n_layers):
    cfg = ge._tiny_cfg(n_layers=n_layers, sample_intvs=16)
    params = jax_init_matchnerf(jax.random.PRNGKey(0), cfg)
    model = MatchNeRF(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = import_matchnerf_checkpoint(sd, num_transformer_layers=n_layers)
    ref_leaves, ref_tree = jax.tree_util.tree_flatten(params)
    got_leaves, got_tree = jax.tree_util.tree_flatten(back)
    assert got_tree == ref_tree
    for a, b in zip(ref_leaves, got_leaves):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_seeded_init_is_reproducible_and_matches_key_set():
    cfg = ge._tiny_cfg(n_layers=1, sample_intvs=16)
    a = init_matchnerf(cfg, torch.Generator().manual_seed(3)).state_dict()
    b = init_matchnerf(cfg, torch.Generator().manual_seed(3)).state_dict()
    jax_keys = set(state_dict_from_jax(
        jax_init_matchnerf(jax.random.PRNGKey(0), cfg)))
    assert set(a) == jax_keys
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    # kaiming/xavier scales: weights non-trivial, biases zero as in JAX
    assert float(a["nerf_dec.pts_linears.0.weight"].std()) > 0.05
    assert float(a["nerf_dec.pts_bias.bias"].abs().max()) == 0.0
