"""The GMFlow backbone's trident branch (num_output_scales 2 to 4) and the
GMFlow features at num_scales 2 against the JAX package on the CPU in f32.

- the backbone at num_output_scales 1 to 4 from JAX `init_cnn_encoder`
  weights through `backbone_state_dict_from_jax` (strict; `trident_conv`
  from 2 scales on): every map's shape and values against
  `apply_cnn_encoder`, 48x64 images;
- `extract_pair_features` at num_scales 2 (attention splits [2, 4], 1
  transformer layer) against `gmflow_extract_pair_features` on 64x64
  images with `init_gmflow` weights through `gmflow_state_dict_from_jax`;
- fewer attention splits than scales: JAX fails, the port raises a
  ValueError.
Tolerance 2e-5 of each map's largest magnitude, as tests/test_torch_encoder.py
(convolution and attention sums in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchnerf_tpu.models.gmflow.backbone import apply_cnn_encoder, init_cnn_encoder
from matchnerf_tpu.models.gmflow.gmflow import gmflow_extract_pair_features, init_gmflow
from matchnerf_tpu_torch.models.gmflow.backbone import CNNEncoder
from matchnerf_tpu_torch.models.gmflow.gmflow import GMFlow, extract_pair_features
from matchnerf_tpu_torch.weights import backbone_state_dict_from_jax, gmflow_state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401


def _close(got, want):
    assert tuple(got.shape) == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * max(scale, 1.0))


@pytest.mark.parametrize("scales", [1, 2, 3, 4])
def test_backbone_scales_match_jax(scales):
    params = init_cnn_encoder(jax.random.PRNGKey(scales), output_dim=32,
                              num_output_scales=scales)
    model = CNNEncoder(output_dim=32, num_output_scales=scales)
    model.load_state_dict(backbone_state_dict_from_jax(params), strict=True)
    assert ("trident_conv.weight" in model.state_dict()) == (scales > 1)
    x = np.random.default_rng(scales).normal(size=(2, 48, 64, 3)).astype(np.float32)
    want = apply_cnn_encoder(params, jnp.asarray(x), num_output_scales=scales)
    with torch.no_grad():
        got = model(torch.tensor(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == scales
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g.permute(0, 2, 3, 1), np.asarray(w))
        if scales > 1:                            # 3x3, padding 1, stride 2^k on the 1/4 trunk
            assert g.shape[2] == (12 - 1) // 2 ** k + 1
        else:
            assert g.shape[2] == 6


def test_backbone_rejects_five_scales():
    with pytest.raises(ValueError, match="1 to 4"):
        CNNEncoder(num_output_scales=5)


def test_gmflow_two_scales_match_jax():
    params = init_gmflow(jax.random.PRNGKey(0), num_transformer_layers=1, num_scales=2)
    model = GMFlow(num_transformer_layers=1, num_scales=2)
    model.load_state_dict(gmflow_state_dict_from_jax(params), strict=True)
    imgs = np.random.default_rng(0).uniform(0, 1, (1, 2, 64, 64, 3)).astype(np.float32)
    want = gmflow_extract_pair_features(params, jnp.asarray(imgs), [2, 4], n_views=2,
                                        num_scales=2, attention_backend="xla")
    with torch.no_grad():
        got = extract_pair_features(model, torch.tensor(imgs), [2, 4], n_views=2)
    assert len(got) == len(want) == 4
    assert [g.shape[3] for g in got] == [8, 16, 16, 32]
    for g, w in zip(got, want):
        _close(g, np.asarray(w))


def test_gmflow_splits_shorter_than_scales_raise():
    """A list of attention splits shorter than num_scales: JAX fails on the
    scale without its splits (an IndexError), the port names the mismatch."""
    params = init_gmflow(jax.random.PRNGKey(0), num_transformer_layers=1, num_scales=2)
    model = GMFlow(num_transformer_layers=1, num_scales=2)
    model.load_state_dict(gmflow_state_dict_from_jax(params), strict=True)
    imgs = np.random.default_rng(1).uniform(0, 1, (1, 2, 64, 64, 3)).astype(np.float32)
    with pytest.raises(IndexError):
        gmflow_extract_pair_features(params, jnp.asarray(imgs), [2], n_views=2, num_scales=2,
                                     attention_backend="xla")
    with pytest.raises(ValueError, match="fewer than the backbone's 2 scales"):
        with torch.no_grad():
            extract_pair_features(model, torch.tensor(imgs), [2], n_views=2)
