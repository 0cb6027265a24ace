"""The port's training step (matchnerf_tpu_torch.train_step, .engine) vs the
JAX package's (matchnerf_tpu.train_step), on the CPU.

- `make_schedule` vs optax's cosine onecycle schedule at every step, rtol
  1e-6. The reference is optax's schedule function evaluated op by op on
  int32 counts; jitting it lets XLA fuse the tail's multiply-add, which
  moves the last steps of a 1000-step run by up to 2e-5 relative, so the
  reference is not jitted.
- `build_optimizer`: one update on identical gradients vs the JAX
  optimizer, the encoder clip triggered and not, rtol 1e-6 on the new
  parameters.
- The whole step (`run_parity`): the port's `Coach` route and `TrainStep`
  vs JAX `make_train_step` on its direct route (banded_kt None,
  attention_backend xla: the route the JAX tests hold equal to its
  kernels), from the same weights (`state_dict_from_jax`), with JAX's ray
  and depth draws fed into the port: loss, every parameter gradient, and
  the loss over 3 optimizer steps. The configs/train.yaml recipe with the
  f32 policy runs here; the train_fast.yaml (block) recipe and the bf16
  policy in tests/test_torch_train_fast.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.train_step import build_optimizer as jax_build_optimizer
from matchnerf_tpu.train_step import make_schedule as jax_make_schedule
from matchnerf_tpu.train_step import make_train_step as jax_make_train_step
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch.engine import Coach
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF
from matchnerf_tpu_torch.train_step import build_optimizer, make_schedule
from matchnerf_tpu_torch.weights import state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401

H, W, N_RAYS, S, T = 32, 32, 32, 16, 50


def _train_cfg(patches: bool, bf16: bool):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=S)))
    cfg.encoder = DotDict({**cfg.encoder, "attention_backend": "xla"})
    cfg.nerf = DotDict({**cfg.nerf, "rand_rays_train": N_RAYS,
                        "train_ray_patches": patches})
    dt = "bfloat16" if bf16 else "float32"
    cfg.precision = DotDict({"encoder_compute_dtype": dt, "decoder_compute_dtype": dt,
                             "banded_kernel": True, "block_kernel": True})
    cfg.data_train = DotDict({"img_wh": [W, H]})
    cfg.freq = DotDict({"scalar": 1})
    return cfg


def _jax_draws(key, patches: bool):
    """The ray indices and depth jitter JAX's loss_fn draws from `key`
    (train_step.py:160-187)."""
    rng_rays, rng_depth = jax.random.split(key)
    if patches:
        starts = jax.random.permutation(rng_rays, H * W // 8)[:N_RAYS // 8] * 8
        idx = (starts[:, None] + jnp.arange(8)[None]).reshape(-1)
    else:
        idx = jax.random.permutation(rng_rays, H * W)[:N_RAYS]
    rand = jax.random.uniform(rng_depth, (1, N_RAYS, S, 1))
    return torch.tensor(np.asarray(idx)), torch.tensor(np.asarray(rand))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def run_parity(patches: bool, bf16: bool, loss_rtol=1e-5, grad_tol=(5e-6, 2e-3),
               grad_rel_l2=None, steps_rtol=1e-4):
    """The port's step vs JAX make_train_step: (1) loss and gradients of one
    step from the same weights and draws, each gradient within atol/rtol
    `grad_tol`; or, with `grad_rel_l2` = (max, median), each gradient of
    norm > 1e-3 within relative L2 error `max`, their median within
    `median`, and the smaller ones within atol 1e-4; (2) the loss of 3
    AdamW steps, rtol `steps_rtol`."""
    cfg = _train_cfg(patches, bf16)
    d = ge._synthetic_inputs(cfg, 1, H, W, R=N_RAYS)
    batch_np = {"images": d["images"], "extrinsics": d["poses"],
                "intrinsics": d["intr"], "near_fars": d["near_fars"]}
    batch_j = {"images": jnp.asarray(d["images"]), "extrinsics": jnp.asarray(d["poses"]),
               "intrinsics": jnp.asarray(d["intr"]),
               "near_fars": jnp.asarray(d["near_fars"]), "tgt_c2w": jnp.asarray(d["tgt_c2w"])}
    params = jax_init(jax.random.PRNGKey(0), cfg)

    def port():
        model = MatchNeRF(cfg)
        model.load_state_dict(state_dict_from_jax(params), strict=True)
        coach = Coach(cfg, model, "cpu")
        coach.setup_optimizer(T)
        return model, coach

    # (1) one step's loss and gradients; this optax transform keeps the
    # gradients as its state and leaves the parameters alone
    grab = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    key = jax.random.PRNGKey(7)
    _, jgrads, jloss = jax_make_train_step(cfg, grab, H, W, N_RAYS)(
        params, grab.init(params), batch_j, key)
    model, coach = port()
    route = coach.train_route(batch_np)
    if patches:
        assert route is not None and None not in route, route    # D' at both scales
    else:
        assert route is None                                      # B' at both scales
    idx, rand = _jax_draws(key, patches)
    loss, _ = coach.step.loss(coach.batch_tensors(batch_np), route, idx, rand)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss["all"]), rtol=loss_rtol)
    want = state_dict_from_jax(jgrads)
    rel = []
    for name, p in model.named_parameters():
        got, ref = p.grad.numpy(), want[name].numpy()
        if grad_rel_l2 is None:
            np.testing.assert_allclose(got, ref, atol=grad_tol[0], rtol=grad_tol[1],
                                       err_msg=name)
        elif np.linalg.norm(ref) > 1e-3:
            rel.append(_rel_l2(got, ref))
            assert rel[-1] <= grad_rel_l2[0], (name, rel[-1])
        else:
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0, err_msg=name)
    if grad_rel_l2 is not None:
        assert np.median(rel) <= grad_rel_l2[1], np.median(rel)

    # (2) three optimizer steps on both sides
    tx, _ = jax_build_optimizer(cfg, T)
    jstep = jax_make_train_step(cfg, tx, H, W, N_RAYS)
    jparams, jstate = params, tx.init(params)
    model, coach = port()
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(11), 3)):
        jparams, jstate, jl = jstep(jparams, jstate, batch_j, key)
        idx, rand = _jax_draws(key, patches)
        got = coach.step(coach.batch_tensors(batch_np), route, idx, rand)
        np.testing.assert_allclose(float(got["all"]), float(jl["all"]), rtol=steps_rtol,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("T", [2, 10, 1000])
def test_schedule_matches_optax(T):
    optim = DotDict({"sched": {"type": "OneCycleLR", "pct_start": 0.05}})
    ref = jax_make_schedule(optim, 5e-4, T)
    mine = make_schedule(optim, 5e-4, T)
    steps = range(T + 3)
    want = np.array([float(ref(jnp.int32(i))) for i in steps])
    got = np.array([mine(i) for i in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == pytest.approx(5e-4 / 25, rel=1e-5)        # the first update uses step 0


@pytest.mark.parametrize("clip", ["triggered", "not_triggered"])
def test_optimizer_update_matches_optax(clip):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=8)))
    params = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(3)
    # encoder gradient norm ~7 (clip 1.0 triggers) or ~0.07 (it does not)
    scale = 1e-3 if clip == "triggered" else 1e-5
    grads = jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32), params)
    enc_norm = np.sqrt(sum(float(np.sum(g ** 2))
                           for g in jax.tree_util.tree_leaves(grads["feat_enc"])))
    assert (enc_norm >= 1.0) == (clip == "triggered")

    T = 100
    tx, _ = jax_build_optimizer(cfg, T)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = state_dict_from_jax(optax.apply_updates(params, updates))

    model = MatchNeRF(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    gsd = state_dict_from_jax(grads)
    for name, p in model.named_parameters():
        p.grad = gsd[name].clone()
    opt = build_optimizer(cfg, model, T)
    opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=name)


def test_frozen_group_takes_no_update():
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=8)))
    cfg.optim = DotDict({**cfg.optim, "lr_enc": 0.0})
    model = MatchNeRF(cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt = build_optimizer(cfg, model, 10)
    opt.step()
    for n, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[n])
        assert moved == n.startswith("nerf_dec"), n


def test_train_step_f32_matches_jax():
    """configs/train.yaml's recipe (iid rays, stratified depths), f32
    policy: loss rtol 1e-5, every parameter gradient atol 5e-6 rtol 2e-3
    (the JAX package's own kernel-vs-direct training test), the loss over 3
    optimizer steps rtol 1e-4."""
    run_parity(patches=False, bf16=False)


def test_train_step_differentiates_through_the_plain_decoder(monkeypatch):
    """configs/train.yaml sets precision.decoder_kernel for its eval renders;
    Kernel C is forward-only, so the training step must not route through
    it (the JAX step never does): every decoder parameter gets a gradient
    and the kernel wrapper is never called while autograd records."""
    import matchnerf_tpu_torch.models.matchnerf as mm
    cfg = _train_cfg(patches=False, bf16=False)
    cfg.precision.decoder_kernel = True
    d = ge._synthetic_inputs(cfg, 1, H, W, R=N_RAYS)
    model = MatchNeRF(cfg)
    coach = Coach(cfg, model, "cpu")
    coach.setup_optimizer(T)

    def refuse(*args, **kwargs):
        raise AssertionError("Kernel C called inside a training step")

    monkeypatch.setattr(mm, "cond_nerf_decode", refuse)
    batch = {"images": d["images"], "extrinsics": d["poses"], "intrinsics": d["intr"],
             "near_fars": d["near_fars"]}
    loss, _ = coach.step.loss(coach.batch_tensors(batch))
    loss.backward()
    assert all(p.grad is not None for p in model.nerf_dec.parameters())
