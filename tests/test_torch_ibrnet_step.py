"""The train_ibrnet step of the port against JAX `make_train_step`, on the
CPU: the recipe (IBR decoder variant, iid rays, stratified depths,
`attn_splits_list: [4]`), the f32 policy, 1 layer, S = 8, 32 rays, with
JAX's ray and depth draws fed in (`TrainStep.loss(..., ray_idx,
depth_rand)`): the loss rtol 1e-5, every decoder gradient atol 5e-6 rtol
2e-3 (as tests/test_torch_train_step.py), every encoder gradient within 2 %
relative L2 (the reason is in `_step_parity`), at 128x64 and at the
recipe's 756x1008 (the encoder's resize and L = 768 windows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from ibrnet_common import H, SMALL_WH, W, full_sample, jax_cfg, port_model, small_tree  # noqa: F401
from matchnerf_tpu import camera as jcamera
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.train_step import make_train_step as jax_make_train_step
from matchnerf_tpu_torch.data import DATASETS
from matchnerf_tpu_torch.data.loader import collate
from matchnerf_tpu_torch.engine import Coach
from matchnerf_tpu_torch.weights import state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401


def _step_parity(batch, img_h, img_w, decoder_rel_l2=None):
    """The port's train_ibrnet step (IBR decoder variant, iid rays,
    stratified depths, 1 layer, S = 8, 32 rays, f32 policy) vs JAX
    `make_train_step` from the same weights with JAX's ray and depth draws:
    the loss rtol 1e-5 and every decoder gradient atol 5e-6 rtol 2e-3, as
    tests/test_torch_train_step.py; every encoder gradient of norm > 1e-3
    within 2e-2 relative L2 error (the rest, such as the biases that
    instance norm cancels, atol 5e-6). The encoder's gradients pass the
    backbone's instance norms, whose backward subtracts per-channel means
    over every position of the view: on the synthetic scene's images at
    128x64 and at 756x1008 the two frameworks' f32 sums, in other orders,
    leave 0.2-0.8 % relative L2 between them (measured; the loss agrees to
    1e-7, and tests/test_torch_train_step.py's 32x32 noise images stay
    within its atol). With `decoder_rel_l2`, the decoder's gradients of
    norm > 1e-3 within that relative L2 error instead."""
    n_rays, S = 32, 8
    cfg = jax_cfg(sample_intvs=S, rand_rays_train=n_rays)
    cfg.data_train.img_wh = [img_w, img_h]
    extr = np.asarray(batch["extrinsics"])
    batch_np = {k: np.asarray(batch[k]) for k in ("images", "extrinsics", "intrinsics",
                                                   "near_fars")}
    batch_j = {k: jnp.asarray(v) for k, v in batch_np.items()}
    batch_j["tgt_c2w"] = jnp.asarray(jcamera.pose_inverse_legacy_np(extr[:, -1, :3, :]))
    params = jax_init(jax.random.PRNGKey(0), cfg)
    # an optax transform that keeps the gradients as its state
    grab = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    key = jax.random.PRNGKey(7)
    _, jgrads, jloss = jax_make_train_step(cfg, grab, img_h, img_w, n_rays)(
        params, grab.init(params), batch_j, key)

    model = port_model(cfg, params)
    coach = Coach(cfg, model, "cpu")
    coach.setup_optimizer(10)
    assert coach.train_route(batch_np) is None                # B' at both scales
    rng_rays, rng_depth = jax.random.split(key)
    idx = torch.tensor(np.asarray(jax.random.permutation(rng_rays, img_h * img_w)[:n_rays]))
    rand = torch.tensor(np.asarray(jax.random.uniform(rng_depth, (1, n_rays, S, 1))))
    loss, _ = coach.step.loss(coach.batch_tensors(batch_np), None, idx, rand)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss["all"]), rtol=1e-5)
    want = state_dict_from_jax(jgrads)
    for name, p in model.named_parameters():
        got, ref = p.grad.numpy(), want[name].numpy()
        rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
        if name.startswith("feat_enc.") and np.linalg.norm(ref) > 1e-3:
            assert rel <= 2e-2, (name, rel)
        elif decoder_rel_l2 is not None and np.linalg.norm(ref) > 1e-3:
            assert rel <= decoder_rel_l2, (name, rel)
        elif name.startswith("feat_enc."):
            np.testing.assert_allclose(got, ref, atol=5e-6, rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, atol=5e-6, rtol=2e-3, err_msg=name)


def test_train_ibrnet_step_matches_jax(small_tree):
    """The recipe's step at 128x64 (windows of 2 x 4 tokens)."""
    sample = DATASETS["ibrnet"](small_tree, "train", img_wh=SMALL_WH)
    batch = collate([sample[0]])
    _step_parity(batch, SMALL_WH[1], SMALL_WH[0])


def test_train_ibrnet_step_756x1008_matches_jax(full_sample):
    """The step at 756x1008: the encoder's resize and its L = 768 windows.
    The resize's lattices differ in the last bit (see the resize test), so
    the decoder's inputs differ in the fifth digit here and its gradients
    are held within 1e-3 relative L2 each."""
    _step_parity(full_sample, H, W, decoder_rel_l2=1e-3)
