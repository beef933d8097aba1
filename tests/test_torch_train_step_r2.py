"""The port's fusion-phase train step against the JAX package's, rounds
>= 2 (MSE + SSIM, and cross-entropy through the frozen seg network on the
unclipped recombination, weighted by DWA), on the CPU in f32: mit_b0 at
32x32, batch 2, 5 classes, about a tenth of the labels ignored
(``train_parity``). Round 1 is in test_torch_train_step.py.
"""
import pytest

from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from train_parity import assert_step_matches_jax


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_round2_step_matches_jax(grad_accum):
    assert_step_matches_jax(round1=False, grad_accum=grad_accum)
