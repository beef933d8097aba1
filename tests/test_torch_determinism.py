"""The deterministic forms that make the port's trainer repeatable on the
card, held on the CPU in f64:

 - the segmentation losses' label pick (a one-hot mask summed over the
   classes, in place of ``gather``, whose CUDA backward sums with float
   atomics): value and gradient against the ``gather`` formulation it
   replaces and against the JAX package's cross entropy, within 1e-12;
 - ``resize_bilinear``'s integer-factor route (``F.interpolate``'s
   forward, the adjoint of ``upsample_bilinear_int`` as its backward) at
   the ratios the training path runs (head 2, 4, 8; logits 4; taps 4, 8):
   the forward bit for bit and the gradient within 1e-12 of
   ``F.interpolate``'s;
 - ``utils.determinism``: the mode's switches, and the scope that keeps
   integer atomics out of it.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from train_parity import jax_in_f64
from segmif_tpu.losses.seg_loss import cross_entropy as jax_ce
from segmif_tpu_torch.eval.metrics import confusion_matrix
from segmif_tpu_torch.losses import seg_loss
from segmif_tpu_torch.ops import image
from segmif_tpu_torch.utils import determinism

F64 = torch.float64


def _gather_ce(logits, labels, ignore_index=255):
    """The formulation the one-hot pick replaced."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    logpt = logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    nll = torch.where(valid, -logpt, torch.zeros_like(logpt))
    return nll.sum() / valid.sum().clamp_min(1)


@pytest.mark.parametrize("classes,ignored", [(9, 0.1), (15, 0.3), (5, 1.0)])
def test_label_pick_matches_gather_and_jax_f64(classes, ignored):
    rng = np.random.default_rng(classes)
    logits = rng.standard_normal((2, 12, 16, classes)) * 3
    labels = rng.integers(0, classes, (2, 12, 16)).astype(np.int32)
    labels[rng.uniform(size=labels.shape) < ignored] = 255
    lab = torch.from_numpy(labels)
    grads = []
    for fn in (seg_loss.cross_entropy, _gather_ce):
        x = torch.tensor(logits, dtype=F64, requires_grad=True)
        loss = fn(x, lab)
        g, = torch.autograd.grad(loss, x)
        grads.append((loss.detach(), g))
    (got, g_got), (old, g_old) = grads
    torch.testing.assert_close(got, old, rtol=0, atol=1e-12)
    torch.testing.assert_close(g_got, g_old, rtol=0, atol=1e-12)
    import jax

    with jax_in_f64():
        want, g_want = jax.value_and_grad(jax_ce)(jnp.asarray(logits),
                                                  jnp.asarray(labels))
        want, g_want = np.asarray(want), np.asarray(g_want)
    assert g_want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(g_got.numpy(), g_want, rtol=0, atol=1e-12)


def test_label_pick_has_no_gather_in_its_graph():
    x = torch.randn((1, 4, 4, 9), dtype=F64, requires_grad=True)
    lab = torch.randint(0, 9, (1, 4, 4))
    loss = seg_loss.cross_entropy(x, lab)
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    names = {type(f).__name__ for f in seen}
    assert not any("Gather" in n for n in names), names


# (input [B, H, W, C], output size): the head's stage-2..4 resizes to
# stage 1 at a 64x96 crop, the logits to the labels, the taps to the trunk
RESIZES = {"head x2": ((2, 8, 12, 16), (16, 24)),
           "head x4": ((2, 4, 6, 16), (16, 24)),
           "head x8": ((2, 2, 3, 16), (16, 24)),
           "logits x4": ((2, 16, 24, 9), (64, 96)),
           "tap1 x4": ((1, 16, 24, 64), (64, 96)),
           "tap2 x8": ((1, 8, 12, 64), (64, 96)),
           "rows x2, cols x4": ((1, 5, 3, 4), (10, 12))}


@pytest.mark.parametrize("name", list(RESIZES))
def test_resize_int_route_matches_interpolate_f64(name):
    shape, size = RESIZES[name]
    rng = np.random.default_rng(len(name))
    x0 = torch.tensor(rng.standard_normal(shape))
    g = torch.tensor(rng.standard_normal(shape[:1] + size + shape[3:]))
    x = x0.clone().requires_grad_(True)
    y = image.resize_bilinear(x, size)
    assert type(y.grad_fn).__name__ == "_ResizeIntFnBackward"
    gx, = torch.autograd.grad(y, x, g)
    xr = x0.clone().requires_grad_(True)
    yr = F.interpolate(xr.permute(0, 3, 1, 2), size=size, mode="bilinear",
                       align_corners=False).permute(0, 2, 3, 1)
    gr, = torch.autograd.grad(yr, xr, g)
    torch.testing.assert_close(y, yr, rtol=0, atol=0)
    torch.testing.assert_close(gx, gr, rtol=0, atol=1e-12)


def test_resize_keeps_interpolate_off_the_integer_route():
    """A ratio that is not whole, and calls without a gradient, run
    ``F.interpolate`` as before."""
    x = torch.randn((1, 9, 15, 4), dtype=F64, requires_grad=True)
    y = image.resize_bilinear(x, (68, 120))
    up = y.grad_fn.next_functions[0][0]     # under the NHWC permute
    assert "UpsampleBilinear" in type(up).__name__
    with torch.no_grad():
        z = image.resize_bilinear(x, (18, 30))
    assert z.grad_fn is None and z.shape == (1, 18, 30, 4)


@contextlib.contextmanager
def _restore_mode():
    on = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(on, warn_only=warn)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn


@pytest.mark.parametrize("warn_only", [False, True])
def test_enable_sets_the_mode_and_integer_exact_scopes_it(warn_only,
                                                          monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with _restore_mode():
        determinism.enable(warn_only=warn_only)
        assert torch.are_deterministic_algorithms_enabled()
        assert (torch.is_deterministic_algorithms_warn_only_enabled()
                is warn_only)
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        import os

        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        with determinism.integer_exact():
            assert not torch.are_deterministic_algorithms_enabled()
        assert torch.are_deterministic_algorithms_enabled()
        assert (torch.is_deterministic_algorithms_warn_only_enabled()
                is warn_only)
        # the confusion matrix counts the same under the mode
        t = torch.tensor([0, 1, 2, 255, 1])
        p = torch.tensor([0, 2, 2, 0, 1])
        want = torch.zeros((3, 3), dtype=torch.int64)
        for a, b in ((0, 0), (1, 2), (2, 2), (1, 1)):
            want[a, b] += 1
        assert torch.equal(confusion_matrix(t, p, 3), want)
    with determinism.integer_exact():    # a no-op outside the mode
        assert not torch.are_deterministic_algorithms_enabled()
