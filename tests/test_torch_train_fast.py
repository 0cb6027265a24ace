"""The port's training step vs JAX `make_train_step` on the CPU, continued
from tests/test_torch_train_step.py (`run_parity` there).

- configs/train_fast.yaml's recipe (8-pixel ray strips): the port's pose
  route takes the block prior (D', its plain version here) at both scales,
  JAX its direct route; f32 policy, the tolerances of the f32 per-ray case
  (loss rtol 1e-5, gradients atol 5e-6 rtol 2e-3, 3-step loss rtol 1e-4).
- configs/train.yaml's bf16 policy (bf16 encoder and decoder, f32 master
  weights). The two frameworks round to bf16 at other places (convolution
  and matmul epilogues, the norms' casts, the attention's P), and at random
  weights a gradient moves with each bf16 rounding about as much as it
  moves from f32 to bf16 within one framework, tens of per cent of its norm
  for a few tensors. Stated tolerance: loss rtol 2e-3, each gradient of
  norm > 1e-3 within relative L2 0.5 and their median within 0.15, smaller
  gradients within atol 1e-4, the 3-step loss rtol 5e-3.
"""
from test_torch_train_step import run_parity


def test_train_fast_step_f32_matches_jax():
    run_parity(patches=True, bf16=False)


def test_train_step_bf16_matches_jax():
    run_parity(patches=False, bf16=True, loss_rtol=2e-3, grad_rel_l2=(0.5, 0.15),
               steps_rtol=5e-3)
