"""The port's seg-phase step (``train.steps.make_seg_train_step``) against
the JAX package's in f32: mit_b0 at 32x32, batch 2, 5 classes, one data
seed, drop-path and dropout at 0 on both sides (``seg_parity``). The
loss within rtol 1e-5; every gradient leaf within 1e-3 of its largest
magnitude (the five leaves whose exact gradient is zero, within 1e-6 of
the largest gradient: ``seg_parity.exact_zero_grad``); the BatchNorm
running mean and variance within 1e-5 of each buffer's largest
magnitude. The aux classifier takes no gradient on either side, and one
3-group AdamW update decays it on both alike. A running variance folded
unbiased, as ``F.batch_norm(training=True)`` folds it, fails the check.

Updated leaves are not compared element by element: Adam's first step
divides each gradient element by its own magnitude plus 1e-8, so an
element within rounding of zero (in f32) or near 1e-8 (in f64) moves by
+-lr on one side and by another amount on the other. The optimizer
itself is held to optax in test_torch_losses.py.
"""
import numpy as np
import pytest

import seg_parity as sp
from segmif_tpu_torch.models import segformer_head
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

DATA_SEED = 3
CLASSIFIER = "denoise_net.classifier.weight"


@pytest.fixture(scope="module")
def jax_side():
    """JAX's results, KeepGrads and AdamW, with the regularisers at 0."""
    with pytest.MonkeyPatch.context() as mp:
        sp.no_regularisers(mp)
        model, variables = sp.jax_variables()
        data = sp.batch(DATA_SEED)
        return variables, data, {a: sp.run_jax(model, variables, data, a)
                                 for a in (False, True)}


def test_seg_step_gradients_match_jax(jax_side, monkeypatch):
    sp.no_regularisers(monkeypatch)
    variables, data, want = jax_side
    w_loss, w_grads, w_stats = want[False]
    loss, grads, stats = sp.run_port(sp.port_model(variables), data, False)
    np.testing.assert_allclose(loss, w_loss, rtol=1e-5)
    sp.assert_leaves_close(grads, w_grads, 1e-3, 1e-6)
    sp.assert_stats_close(stats, w_stats, 1e-5)
    assert not grads[CLASSIFIER].any() and not w_grads[CLASSIFIER].any()
    # the statistics moved: momentum 0.9 from (0, 1)
    assert np.abs(stats[next(iter(stats))]).max() > 0


def test_seg_step_adamw_decays_the_classifier(jax_side, monkeypatch):
    """One 3-group AdamW update: the classifier's change (its weight decay
    at the decoder's 10x lr, with a zero gradient) as JAX's; the loss and
    the running statistics as above."""
    sp.no_regularisers(monkeypatch)
    variables, data, want = jax_side
    w_loss, w_params, w_stats = want[True]
    model = sp.port_model(variables)
    before = model.denoise_net.classifier.weight.detach().clone().numpy()
    loss, params, stats = sp.run_port(model, data, True)
    np.testing.assert_allclose(loss, w_loss, rtol=1e-5)
    sp.assert_stats_close(stats, w_stats, 1e-5)
    got, exp = params[CLASSIFIER] - before, w_params[CLASSIFIER] - before
    assert np.abs(exp).max() > 0
    np.testing.assert_allclose(got, exp, rtol=0,
                               atol=1e-3 * np.abs(exp).max())


def test_unbiased_running_var_fails_the_check(jax_side, monkeypatch):
    """Planted fault: the running variance folded with the unbiased batch
    variance (n / (n - 1) at n = 2x8x8 values per channel)."""
    sp.no_regularisers(monkeypatch)
    real = segformer_head.update_running_stats

    def unbiased(bn, mean, var, count):
        real(bn, mean, var * count / (count - 1), count)

    monkeypatch.setattr(segformer_head, "update_running_stats", unbiased)
    variables, data, want = jax_side
    _, _, stats = sp.run_port(sp.port_model(variables), data, False)
    w_stats = want[False][2]
    for k in stats:
        check = lambda: sp.assert_stats_close(  # noqa: E731
            {k: stats[k]}, {k: w_stats[k]}, 1e-5)
        if k.endswith("running_mean"):
            check()
        else:
            with pytest.raises(AssertionError):
                check()
