"""The port's fusion-phase train step against the JAX package's in f64 on
both sides, round 1 (L1 + Sobel), on four data seeds: mit_b0 at 32x32,
batch 2, 5 classes (``train_parity.assert_step_matches_jax_f64``). In f64
no relu input lies within rounding of zero, so every seed is held, to
1e-5 of each leaf's largest magnitude. Rounds >= 2 are in
test_torch_train_step_f64_r2.py, so the JAX compiles run on two workers.
"""
import pytest

from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from train_parity import assert_step_matches_jax_f64


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_round1_step_matches_jax_f64(seed):
    assert_step_matches_jax_f64(round1=True, seed=seed)
