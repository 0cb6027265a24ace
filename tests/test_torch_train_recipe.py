"""The rest of the training recipe in the port, against the JAX package where
it has a counterpart, on the CPU.

- ExponentialLR (`make_schedule`): optax.exponential_decay(peak,
  transition_steps=1, decay_rate=gamma), a decay per step; 20 steps of
  learning rates equal in f32 to optax's (evaluated op by op, as
  tests/test_torch_train_step.py does for OneCycle).
- Adam (`build_optimizer`, `algo.type: Adam`): optax.adam with no weight
  decay whatever `weight_decay` says, the encoder clipped; the parameters
  after 3 updates on identical gradients vs the JAX optimizer, clip
  triggered and not, rtol 1e-6 atol 5e-8 (a few f32 ulps of the weights).
- The GMFlow-filtered encoder init (`weights.load_gmflow_pretrained`) vs
  JAX `import_gmflow_pretrained` on a synthetic GMFlow checkpoint of 6
  transformer layers with DataParallel prefixes, a flow upsampler and a
  flow refinement, loaded into a model of 2 layers: every encoder tensor
  equal to the JAX params through the weight bridge, `featup_net` and the
  decoder at their seeded values; the engine loads it through
  `encoder.pretrain_weight`, and not with `load` or `resume`; an absent
  file warns.
- `precision.remat_encoder`: every gradient of a small step with the
  transformer layers checkpointed equals the step without (f32, 1e-6), and
  the backward runs each layer's window attention once more.
"""
import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.import_torch import import_gmflow_pretrained
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.train_step import build_optimizer as jax_build_optimizer
from matchnerf_tpu.train_step import make_schedule as jax_make_schedule
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch.engine import Coach
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF, init_matchnerf
from matchnerf_tpu_torch.train_step import build_optimizer, make_schedule
from matchnerf_tpu_torch.weights import load_gmflow_pretrained, state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401

H, W, N_RAYS, S = 32, 32, 32, 8


@pytest.mark.parametrize("gamma", [0.95, 0.999, 1.0])
def test_exponential_schedule_matches_optax(gamma):
    optim = DotDict({"sched": {"type": "ExponentialLR", "gamma": gamma}})
    ref = jax_make_schedule(optim, 5e-4, 100)
    mine = make_schedule(optim, 5e-4, 100)
    want = np.array([np.float32(ref(jnp.int32(i))) for i in range(20)])
    got = np.array([np.float32(mine(i)) for i in range(20)])
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(5e-4)                # the first update uses step 0
    if gamma < 1.0:
        assert got[1] < got[0]                       # decays per step, not per epoch


def _adam_cfg():
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=8)))
    cfg.optim = DotDict({**cfg.optim,
                         "algo": DotDict({"type": "Adam", "weight_decay": 1e-2}),
                         "sched": DotDict({"type": "ExponentialLR", "gamma": 0.9})})
    return cfg


@pytest.mark.parametrize("clip", ["triggered", "not_triggered"])
def test_adam_matches_optax(clip):
    cfg = _adam_cfg()
    params = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(5)
    scale = 1e-3 if clip == "triggered" else 1e-5     # encoder norm ~7 or ~0.07
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32), params)
        for _ in range(3)]
    enc_norm = np.sqrt(sum(float(np.sum(g ** 2))
                           for g in jax.tree_util.tree_leaves(grads[0]["feat_enc"])))
    assert (enc_norm >= 1.0) == (clip == "triggered")

    tx, _ = jax_build_optimizer(cfg, 100)
    state, jparams = tx.init(params), params
    model = MatchNeRF(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    opt = build_optimizer(cfg, model, 100)
    assert type(opt.opt) is torch.optim.Adam
    assert all(g["weight_decay"] == 0.0 for g in opt.opt.param_groups)
    update = jax.jit(tx.update)
    for g in grads:
        updates, state = update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        gsd = state_dict_from_jax(g)
        for name, p in model.named_parameters():
            p.grad = gsd[name].clone()
        opt.step()
    want = state_dict_from_jax(jparams)
    # a few f32 ulps: each update rounds in its own operation order
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=5e-8, err_msg=name)


def _gmflow_checkpoint(path):
    """A GMFlow flow checkpoint as the reference saves it: a seeded
    6-layer encoder's backbone and transformer under `module.`, its flow
    upsampler and flow refinement, no featup_net."""
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=6)))
    enc = init_matchnerf(cfg, torch.Generator().manual_seed(11)).feat_enc
    sd = {f"module.{k}": v.clone() for k, v in enc.state_dict().items()
          if not k.startswith("featup_net.")}
    gen = torch.Generator().manual_seed(12)
    sd["module.upsampler.0.weight"] = torch.randn(256, 129, 3, 3, generator=gen)
    sd["module.upsampler.2.bias"] = torch.randn(144, generator=gen)
    sd["module.feature_flow_attn.q_proj.weight"] = torch.randn(128, 128, generator=gen)
    torch.save({"model": sd, "step": 100000}, path)
    return sd


def test_gmflow_pretrained_matches_jax(tmp_path):
    path = str(tmp_path / "gmflow.pth")
    sd = _gmflow_checkpoint(path)
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=2)))
    params = jax_init(jax.random.PRNGKey(0), cfg)
    jparams = dict(params)
    jparams["feat_enc"] = import_gmflow_pretrained(path, params["feat_enc"],
                                                   gmflow_n_blocks=2)
    want = state_dict_from_jax(jparams)

    model = MatchNeRF(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    seeded = copy.deepcopy(model.state_dict())
    load_gmflow_pretrained(model.feat_enc, path)
    got = model.state_dict()
    assert len(model.feat_enc.transformer.layers) == 2
    for name, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[name].numpy(), err_msg=name)
        if name.startswith(("feat_enc.backbone.", "feat_enc.transformer.")):
            assert torch.equal(value, sd["module." + name[len("feat_enc."):]]), name
        else:                                        # featup_net, the decoder
            assert torch.equal(value, seeded[name]), name
    assert not torch.equal(got["feat_enc.backbone.conv1.weight"],
                           seeded["feat_enc.backbone.conv1.weight"])


def test_gmflow_pretrained_needs_every_layer(tmp_path):
    path = str(tmp_path / "gmflow.pth")
    _gmflow_checkpoint(path)
    model = MatchNeRF(DotDict(dict(ge._tiny_cfg(n_layers=7))))
    with pytest.raises(KeyError, match="transformer.layers.6"):
        load_gmflow_pretrained(model.feat_enc, path)


@pytest.mark.parametrize("case", ["pretrain", "load", "resume", "absent"])
def test_engine_encoder_init(tmp_path, caplog, case):
    """build_networks loads encoder.pretrain_weight into the encoder only
    without load and resume, and warns when the file is absent."""
    path = str(tmp_path / "gmflow.pth")
    sd = _gmflow_checkpoint(path)
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1)))
    cfg.encoder = DotDict({**cfg.encoder, "pretrain_weight": path})
    if case == "absent":
        cfg.encoder.pretrain_weight = str(tmp_path / "missing.pth")
    elif case == "load":
        cfg.load = str(tmp_path / "run.ckpt")
    elif case == "resume":
        cfg.resume = True
    seeded = init_matchnerf(cfg, torch.Generator().manual_seed(0)).state_dict()
    coach = Coach(cfg, device="cpu")
    with caplog.at_level(logging.INFO):
        coach.build_networks()
    got = coach.model.state_dict()
    for name, value in got.items():
        key = "module." + name[len("feat_enc."):]
        if case == "pretrain" and key in sd:
            assert torch.equal(value, sd[key]), name
        else:
            assert torch.equal(value, seeded[name]), name
    if case == "absent":
        assert "not found" in caplog.text


def _remat_grads(remat: bool):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=2, sample_intvs=S)))
    cfg.nerf = DotDict({**cfg.nerf, "rand_rays_train": N_RAYS})
    cfg.precision = DotDict({"remat_encoder": remat})
    cfg.data_train = DotDict({"img_wh": [W, H]})
    d = ge._synthetic_inputs(cfg, 1, H, W, R=N_RAYS)
    model = init_matchnerf(cfg, torch.Generator().manual_seed(0))
    coach = Coach(cfg, model, "cpu")
    coach.setup_optimizer(10)
    batch = {"images": d["images"], "extrinsics": d["poses"], "intrinsics": d["intr"],
             "near_fars": d["near_fars"]}
    rng = np.random.default_rng(2)
    idx = torch.tensor(rng.permutation(H * W)[:N_RAYS])
    rand = torch.tensor(rng.uniform(0, 1, (1, N_RAYS, S, 1)).astype(np.float32))
    loss, _ = coach.step.loss(coach.batch_tensors(batch), None, idx, rand)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_encoder_gradients_equal(monkeypatch):
    from matchnerf_tpu_torch.ops import attention
    calls = []
    plain = attention.window_attention

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)
    monkeypatch.setattr(attention, "window_attention", counted)
    loss_off, grads_off = _remat_grads(False)
    n_off = len(calls)
    calls.clear()
    loss_on, grads_on = _remat_grads(True)
    # 2 layers x (self, cross) attention; the backward runs each again
    assert (n_off, len(calls)) == (4, 8)
    assert loss_on == loss_off
    for name, g in grads_off.items():
        np.testing.assert_allclose(grads_on[name].numpy(), g.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
