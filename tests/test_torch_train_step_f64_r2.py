"""The port's fusion-phase train step against the JAX package's in f64 on
both sides, rounds >= 2 (MSE + SSIM, and cross-entropy through the frozen
seg network, weighted by DWA), on four data seeds: mit_b0 at 32x32, batch
2, 5 classes, about a tenth of the labels ignored
(``train_parity.assert_step_matches_jax_f64``). Round 1 is in
test_torch_train_step_f64.py.
"""
import pytest

from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from train_parity import assert_step_matches_jax_f64


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_round2_step_matches_jax_f64(seed):
    assert_step_matches_jax_f64(round1=False, seed=seed)
