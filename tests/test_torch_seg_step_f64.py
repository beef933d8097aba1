"""The port's seg-phase step against the JAX package's with both in f64
(the JAX step under ``train_parity.jax_in_f64``, the port's with
``compute_dtype=torch.float64``) on data seeds 1-4: the loss within rtol
1e-6, every gradient leaf and BatchNorm buffer within 1e-5 of its largest
magnitude (the leaves whose exact gradient is zero, within 1e-12 of the
largest gradient: ``seg_parity.exact_zero_grad``). Drop-path and dropout
at 0 on both sides (``seg_parity``).
"""
import numpy as np
import pytest
import torch

import seg_parity as sp
from torch_threads import one_thread  # noqa: F401 (autouse fixture)


def _f64(data):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in data.items()}


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_seg_step_matches_jax_f64(seed, monkeypatch):
    sp.no_regularisers(monkeypatch)
    _, variables = sp.jax_variables()
    w_loss, w_grads, w_stats = sp.jax_f64(seed, variables, False)
    loss, grads, stats = sp.run_port(
        sp.port_model(variables, torch.float64), _f64(sp.batch(seed)), False,
        torch.float64)
    np.testing.assert_allclose(loss, w_loss, rtol=1e-6)
    assert all(g.dtype == np.float64 for g in grads.values())
    sp.assert_leaves_close(grads, w_grads, 1e-5, 1e-12)
    sp.assert_leaves_close(stats, w_stats, 1e-5, 0.0)

