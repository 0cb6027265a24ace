"""Sixteen source views: plain Kernels B and D on int8 tables at V = 16
(120 pairs) against the JAX banded and block-banded kernels in interpret
mode (atol 1e-2) and against each other (atol 1e-5), as
tests/test_torch_views_past_eight.py holds them at V = 10; a file of its
own, since tracing the JAX kernels' 120 pairs takes ~100 s."""
from test_torch_views_past_eight import check_priors_int8_match_jax
from torch_threads import one_torch_thread  # noqa: F401


def test_plain_priors_int8_match_jax_sixteen_views():
    check_priors_int8_match_jax(16)
