"""`encoder.feature_upsampler: none` in the port against the JAX package on
the CPU, in f32.

The JAX GMFlow at `none` (models/gmflow/gmflow.py:49, :184-193) builds no
`featup_net` and gives the transformer's features as both stacks. The JAX
MatchNeRF's `encode` (models/matchnerf.py:61) does not pass the config's
key on, so at `none` it looks for `featup_net` and raises a KeyError
(asserted below). The image is therefore held to the JAX render with
`encode` handing the key to `gmflow_extract_pair_features`, as the config
asks; nothing in the JAX package is changed.

- the encoder: `init_gmflow(feature_upsampler="none")` weights through
  `gmflow_state_dict_from_jax` (strict: no `featup_net`) against
  `gmflow_extract_pair_features(..., feature_upsampler="none")`, 2e-5 of
  each stack's largest magnitude (tests/test_torch_encoder.py's bound);
- the model: `state_dict_from_jax` of the JAX MatchNeRF at `none` loads
  strict; one 32x32 image (the tiny two-layer model, configs/test.yaml's
  precision with the f32 encoder) >= 60 dB against the JAX render;
- the training route's grids at `none`: the second table is the 1/8 scale.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_variants import IMG, _model

import __graft_entry__ as ge
from matchnerf_tpu.models import matchnerf as jmn
from matchnerf_tpu.models.gmflow.gmflow import gmflow_extract_pair_features, init_gmflow
from matchnerf_tpu.renderer import Renderer as JaxRenderer
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch.config import dtu_eval_config
from matchnerf_tpu_torch.models.gmflow.gmflow import GMFlow, extract_pair_features
from matchnerf_tpu_torch.models.matchnerf import encode
from matchnerf_tpu_torch.renderer import Renderer
from matchnerf_tpu_torch.weights import gmflow_state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401


def _cfg():
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=2, sample_intvs=48)))
    cfg.encoder = DotDict(dict(cfg.encoder, feature_upsampler="none"))
    cfg.precision = DotDict(dict(dtu_eval_config().precision,
                                 encoder_compute_dtype="float32"))
    return cfg


def test_jax_encode_drops_the_key():
    cfg = _cfg()
    params = jmn.init_matchnerf(jax.random.PRNGKey(0), cfg)
    assert "featup_net" not in params["feat_enc"]
    with pytest.raises(KeyError, match="featup_net"):
        jmn.encode(params, cfg, jnp.zeros((1, 3, 32, 32, 3)))


def test_encoder_without_upsampler_matches_jax():
    params = init_gmflow(jax.random.PRNGKey(1), num_transformer_layers=2,
                         feature_upsampler="none")
    model = GMFlow(num_transformer_layers=2, feature_upsampler="none")
    assert not any(k.startswith("featup_net") for k in model.state_dict())
    model.load_state_dict(gmflow_state_dict_from_jax(params), strict=True)
    imgs = np.random.default_rng(1).uniform(0, 1, (1, 3, 32, 64, 3)).astype(np.float32)
    want = gmflow_extract_pair_features(params, jnp.asarray(imgs), [2], n_views=3,
                                        feature_upsampler="none", attention_backend="xla")
    with torch.no_grad():
        got = extract_pair_features(model, torch.tensor(imgs), [2], n_views=3)
    assert len(got) == len(want) == 2
    assert [tuple(g.shape) for g in got] == [(1, 3, 2, 4, 8, 128)] * 2
    assert torch.equal(got[0], got[1])
    for g, w in zip(got, want):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5 * max(scale, 1.0))


def test_render_without_upsampler_matches_jax(monkeypatch):
    """The port's image >= 60 dB against the JAX render of the same weights
    (JAX on its direct route, `encode` given the key); the tables of both
    scales are the transformer's 1/8 scale."""
    cfg = _cfg()
    params, model = _model(cfg)
    assert not hasattr(model.feat_enc, "featup_net")
    d = ge._synthetic_inputs(cfg, 1, IMG, IMG, R=16)
    batch = {"images": d["images"], "extrinsics": d["poses"], "intrinsics": d["intr"],
             "near_fars": d["near_fars"]}
    with torch.no_grad():
        feats = encode(model, cfg, torch.tensor(d["images"][:, :3]))
    assert [tuple(f.shape[3:5]) for f in feats] == [(IMG // 8, IMG // 8)] * 2
    out = Renderer(cfg, model, "cpu").forward(batch, mode="test")
    monkeypatch.setattr(jmn, "gmflow_extract_pair_features", functools.partial(
        gmflow_extract_pair_features, feature_upsampler="none"))
    jcfg = DotDict(dict(cfg))
    jcfg.precision = DotDict(dict(cfg.precision, banded_kernel=False, block_kernel=False,
                                  color_block_kernel=False, decoder_kernel=False,
                                  fused_cosine=False))
    ref = JaxRenderer(jcfg).forward(params, batch, mode="test")
    for k in ("rgb", "depth", "opacity"):
        assert tuple(out[k].shape) == ref[k].shape and bool(torch.isfinite(out[k]).all())
    mse = float(np.mean((out["rgb"].numpy().astype(np.float64) - ref["rgb"]) ** 2))
    psnr = float("inf") if mse == 0 else -10.0 * np.log10(mse)
    assert psnr >= 60.0, f"agreement PSNR {psnr:.1f} dB < 60"
    assert float(np.abs(ref["rgb"]).max()) > 0.01


def test_training_route_measures_the_tables_grids(monkeypatch):
    """`Coach.train_route` (train_fast.yaml's strips) asks `pose_prep` about
    the tables the step builds: at 640x512 the upsampler's are 64x80 and
    128x160, at `none` both are 64x80."""
    from matchnerf_tpu_torch.config import CONFIGS
    from matchnerf_tpu_torch.engine import Coach
    seen = []
    monkeypatch.setattr(Renderer, "pose_prep",
                        lambda self, poses, scale_hws, *a, **k: seen.append(scale_hws)
                        or (None, None))
    d = ge._synthetic_inputs(_cfg(), 1, 64, 80, R=8)
    batch = {"extrinsics": d["poses"], "intrinsics": d["intr"], "near_fars": d["near_fars"]}
    for upsampler in ("network", "none"):
        cfg = CONFIGS["train_fast"]()
        cfg.encoder.feature_upsampler = upsampler
        coach = Coach(cfg, None, "cpu")
        coach.train_hw = (512, 640, 1024)
        assert coach.train_route(batch) is None
    assert seen == [[(64, 80), (128, 160)], [(64, 80), (64, 80)]], seen
