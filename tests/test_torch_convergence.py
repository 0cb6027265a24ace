"""The port's convergence run (matchnerf_tpu_torch.convergence) on the CPU,
against tests/test_convergence.py's bars and against the JAX run.

- `tiny_config` is the JAX tool's config (`__graft_entry__._tiny_cfg` with
  the convergence optimizer), key by key; the train and train_fast
  recipes add configs/train.yaml's precision block and train_fast.yaml's
  ray strips.
- The tiny recipe from the port's own seeded weights, 80 steps at S = 16,
  held to the JAX test's bars: first loss > 0.05, last < 0.012, the target
  view >= 20 dB.
- `kernels.record_steps`, which gives the run its per-step launches, on a
  stub coach.
- The JAX twin: the port from JAX's `init_matchnerf(PRNGKey(0))` (through
  `weights.state_dict_from_jax`), fed the JAX step's ray and depth draws
  every step, against JAX `make_train_step` over the same 80 steps: the
  first loss at 1e-4, the last within 10 % of JAX's, the target view
  within 0.5 dB of JAX's render (measured: 7.9 % and 0.26 dB, 22.61
  against 22.35 dB). The two runs part by chaos, not by a fault: the loss
  gap is 2e-5 after one update and grows about 3x a step through the
  OneCycle peak (step 8), to 41 % at step 10, then settles. ~95 s on one
  thread, so it is marked slow (the JAX steps take half of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.data.synth import make_scene_views as jax_scene_views
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.renderer import Renderer as JaxRenderer
from matchnerf_tpu.train_step import build_optimizer as jax_build_optimizer
from matchnerf_tpu.train_step import make_train_step as jax_make_train_step
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch import convergence, kernels
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF
from matchnerf_tpu_torch.weights import state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401

STEPS, S = 80, 16
H, W, N_RAYS = convergence.H, convergence.W, convergence.N_RAYS


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax_cfg():
    """tests/test_convergence.py's config (tools/convergence_tpu.py's at
    S = 16)."""
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=2, sample_intvs=S)))
    cfg.encoder.attention_backend = "xla"
    cfg.nerf.rand_rays_train = N_RAYS
    cfg.optim = DotDict({
        "lr_enc": 2e-4, "lr_dec": 5e-3, "clip_enc": 1.0,
        "algo": DotDict({"type": "AdamW", "weight_decay": 0.0}),
        "sched": DotDict({"type": "OneCycleLR", "pct_start": 0.1})})
    return cfg


def test_tiny_config_is_the_jax_tools():
    mine = _flat(convergence.tiny_config(S))
    ref = _flat(_jax_cfg())
    ref.pop("encoder.attention_backend")          # a TPU knob the port leaves out
    ref["nerf.rand_rays_test"] = convergence.TEST_RAYS     # the tool's render slices
    for key, val in ref.items():
        assert mine[key] == val, (key, mine[key], val)
    assert set(mine) - set(ref) == {"seed", "data_train.img_wh"}
    train = convergence.recipe_config("train", S)
    fast = convergence.recipe_config("train_fast", S)
    assert train.precision.banded_kernel and train.precision.block_kernel
    assert train.precision.encoder_compute_dtype == "bfloat16"
    assert train.precision.decoder_compute_dtype == "bfloat16"
    assert not train.nerf.get("train_ray_patches", False)
    assert fast.nerf.train_ray_patches and fast.precision == train.precision
    assert "precision" not in convergence.tiny_config(S)
    with pytest.raises(ValueError):
        convergence.recipe_config("train_ibrnet")


def test_port_overfits_synthetic_scene():
    cfg = convergence.recipe_config("tiny", S)
    res = convergence.run(cfg, STEPS, "cpu", seed=0, log=None)
    first, last = res["losses"][0], res["losses"][-1]
    assert first > 0.05, first
    assert last < 0.012, (first, last)
    assert res["psnr"] >= 20.0, f"overfit PSNR {res['psnr']:.2f} dB < 20"


class _StubCoach:
    """Steps that launch B' once and A' twice, under a route that changes."""

    def __init__(self):
        self.last_route = None
        self.it = 0

    def train_iteration(self, batch, ray_idx=None, depth_rand=None):
        c = kernels.counters()
        c["cosine_prior_bwd"].launches += 1
        c["window_attention_bwd"].launches += 2
        self.last_route = (64, None) if self.it % 2 else None
        self.it += 1
        return {"all": float(self.it), "batch": batch}


def test_record_steps_counts_each_step():
    """`kernels.record_steps` keeps each step's launches and plain versions
    on CUDA (the counts it made, whatever they were before) and its route,
    and passes the step's arguments and result through."""
    coach = _StubCoach()
    c = kernels.counters()
    c["cosine_prior_bwd"].launches += 5          # counted before the recording
    steps = kernels.record_steps(coach)
    outs = [coach.train_iteration(i) for i in range(3)]
    assert [o["batch"] for o in outs] == [0, 1, 2]
    assert [st["route"] for st in steps] == [None, (64, None), None]
    for st in steps:
        assert set(st) == {"launches", "plain_on_cuda", "route"}
        assert set(st["launches"]) == set(c)
        assert {k: v for k, v in st["launches"].items() if v} == {
            "cosine_prior_bwd": 1, "window_attention_bwd": 2}
        assert not any(st["plain_on_cuda"].values())
    for counter in c.values():
        counter.reset()


def _jax_draws(key):
    """The ray indices and depth jitter JAX's step draws from `key`
    (train_step.py:160-187, the iid-ray route)."""
    rng_rays, rng_depth = jax.random.split(key)
    idx = jax.random.permutation(rng_rays, H * W)[:N_RAYS]
    rand = jax.random.uniform(rng_depth, (1, N_RAYS, S, 1))
    return torch.tensor(np.asarray(idx)), torch.tensor(np.asarray(rand))


@pytest.mark.slow
def test_convergence_matches_jax():
    cfg = _jax_cfg()
    v = jax_scene_views(W, H)
    batch = {"images": jnp.asarray(v["images"][None]),
             "extrinsics": jnp.asarray(v["w2cs"][None]),
             "intrinsics": jnp.asarray(v["intrinsics"][None]),
             "near_fars": jnp.asarray(v["near_fars"][None]),
             "tgt_c2w": jnp.asarray(v["c2ws"][None, -1, :3, :])}
    params0 = jax_init(jax.random.PRNGKey(0), cfg)
    tx, _ = jax_build_optimizer(cfg, total_steps=STEPS)
    step = jax_make_train_step(cfg, tx, H, W, N_RAYS)
    params, opt_state = params0, tx.init(params0)
    rng, keys, jlosses = jax.random.PRNGKey(1), [], []
    for _ in range(STEPS):
        rng, k = jax.random.split(rng)
        keys.append(k)
        params, opt_state, losses = step(params, opt_state, batch, k)
        jlosses.append(float(losses["all"]))
    poses = {
        "tgt": {"extrinsics": np.asarray(v["w2cs"][None, -1, :3, :]),
                "intrinsics": np.asarray(v["intrinsics"][None, -1]),
                "near_fars": np.asarray(v["near_fars"][None, -1])},
        "ref": {"extrinsics": np.asarray(v["w2cs"][None, :3, :3, :]),
                "intrinsics": np.asarray(v["intrinsics"][None, :3]),
                "near_fars": np.asarray(v["near_fars"][None, :3])}}
    cfg.nerf.rand_rays_test = convergence.TEST_RAYS
    r = JaxRenderer(cfg)
    ref_images = jnp.asarray(v["images"][None, :3])
    out = r.render_by_slices(params, poses, ref_images, r.encode(params, ref_images), H, W)
    jpsnr = convergence.psnr(np.asarray(out["rgb"][0]).reshape(H, W, 3), v["images"][-1])

    model = MatchNeRF(convergence.tiny_config(S))
    model.load_state_dict(state_dict_from_jax(params0), strict=True)
    res = convergence.run(convergence.recipe_config("tiny", S), STEPS, "cpu", model=model,
                          draws=lambda i: _jax_draws(keys[i]), log=None)
    np.testing.assert_allclose(res["losses"][0], jlosses[0], rtol=1e-4)
    gap = abs(res["losses"][-1] - jlosses[-1]) / jlosses[-1]
    assert gap <= 0.10, (res["losses"][-1], jlosses[-1], gap)
    assert abs(res["psnr"] - jpsnr) <= 0.5, (res["psnr"], jpsnr)
