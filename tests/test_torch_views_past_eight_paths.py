"""Ten source views (`n_src_views`) through the port's paths: the render
and a training step against the JAX package on the CPU.
tests/test_torch_views_past_eight.py holds the forward kernels at V = 10
and 16, tests/test_torch_views_past_eight_grads.py the table gradients.

- a 32x32 image at configs/test.yaml's precision (Kernels D and E, their
  plain versions here) with the f32 encoder at V = 10: >= 60 dB against
  the JAX render on its direct route, and the port's route equal to JAX
  `_pose_prep`'s buckets;
- one configs/train.yaml step (B' at both scales) at V = 10 against JAX
  `make_train_step`, fed JAX's ray and depth draws: the loss and every
  gradient at the tolerances of tests/test_torch_views_many_paths.py's
  six-view step.
"""
from test_torch_train_step import run_parity
from test_torch_views_many_paths import test_render_matches_jax as render_matches_jax

from torch_threads import one_torch_thread  # noqa: F401


def test_render_matches_jax_ten_views():
    """configs/test.yaml's precision at V = 10 on a 32x32 image of the tiny
    two-layer model: >= 60 dB against the JAX render on its direct route,
    the route equal to JAX `_pose_prep`'s buckets (the five- and eight-view
    test's body)."""
    render_matches_jax(10)


def test_train_step_ten_views_matches_jax():
    """One configs/train.yaml step (iid rays: B' at both scales) at V = 10,
    f32 policy, on `_synthetic_inputs`' seed 5 (the six-view step's scene):
    the loss rtol 1e-5 and every parameter gradient atol 5e-6 rtol 2e-3
    against JAX `make_train_step`."""
    run_parity(patches=False, bf16=False, n_views=10, steps=0, seed=5)
