"""The port's fusion-phase train step against the JAX package's, round 1
(L1 + Sobel), on the CPU in f32: mit_b0 at 32x32, batch 2, 5 classes,
seeded numpy inputs, weights through ``convert.state_dict_from_jax``
(``train_parity``). Rounds >= 2 are in test_torch_train_step_r2.py, so
the two JAX compiles run on two workers. Also here: the port's
``grad_accum=2`` over two micro-batches gives the update of one step over
the 2B batch (every loss is a batch mean, the micro-batches are equal).
"""
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from train_parity import (B, CLASSES, FUSION_SCALE, KeepGrads, batch,
                          assert_step_matches_jax)
from segmif_tpu_torch import drift
from segmif_tpu_torch.models.network import JointPipeline
from segmif_tpu_torch.train.optimizer import adamw_poly
from segmif_tpu_torch.train.state import FusionTrainState
from segmif_tpu_torch.train.steps import make_fusion_train_step


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_round1_step_matches_jax(grad_accum):
    assert_step_matches_jax(round1=True, grad_accum=grad_accum)


def _model():
    return drift.init_reference_scale(
        JointPipeline("mit_b0", num_classes=CLASSES),
        torch.Generator().manual_seed(3))


@pytest.mark.parametrize("round1", [True, False])
def test_grad_accum_matches_big_batch(round1):
    """Gradients, losses and the AdamW update of grad_accum=2 over two
    micro-batches of B against one step over the 2B batch."""
    data = {k: torch.from_numpy(v) for k, v in batch(5, (2 * B,)).items()}
    micro = {k: v.reshape((2, B) + v.shape[1:]) for k, v in data.items()}
    out = {}
    for accum, b in ((1, data), (2, micro)):
        for tx in (KeepGrads(), adamw_poly(1e-3, 0, 100)):
            model = _model()
            step = make_fusion_train_step(model, tx, round1,
                                          grad_accum=accum,
                                          compute_dtype=torch.float32,
                                          device="cpu")
            state = FusionTrainState.create(model.fusion, tx)
            metrics = step(state, b, FUSION_SCALE)
            out[accum, type(tx).__name__] = (
                metrics, {k: p.detach().clone()
                          for k, p in state.params.items()},
                state.opt_state)
    (m1, _, g1), (m2, _, g2) = out[1, "KeepGrads"], out[2, "KeepGrads"]
    for k in ("loss", "loss_fusion", "loss_seg"):
        np.testing.assert_allclose(m2[k].numpy(), m1[k].numpy(), rtol=1e-5)
    for k in g1:
        tol = 1e-4 * g1[k].abs().max().item() + 1e-8
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), atol=tol,
                                   err_msg=k)
    (_, p1, _), (_, p2, _) = out[1, "AdamW"], out[2, "AdamW"]
    moved = 0
    for k in p1:
        # a first Adam update is lr * g / (|g| + eps) per element: sign-
        # like, so a gradient near zero may move by up to lr either way
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), atol=2e-3,
                                   err_msg=k)
        moved += int((p1[k] != _model().fusion.state_dict()[k]).any())
    assert moved == len(p1)


def test_step_after_an_inference_mode_forward():
    """A serving forward under torch.inference_mode() before training (the
    ops' cached constants are made outside inference mode, so autograd
    may save them)."""
    model = _model()
    data = {k: torch.from_numpy(v) for k, v in batch(6).items()}
    with torch.inference_mode():
        model(data["ir"], data["vis"])
    tx = adamw_poly(1e-4, 0, 100)
    step = make_fusion_train_step(model, tx, False,
                                  compute_dtype=torch.float32, device="cpu")
    state = FusionTrainState.create(model.fusion, tx)
    metrics = step(state, data, FUSION_SCALE)
    assert bool(torch.isfinite(metrics["loss"])) and int(state.step) == 1


def test_step_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """Without ``device`` the step asks for the card and raises where there
    is none; a state made on another device than the step's is refused."""
    model, tx = _model(), adamw_poly(1e-4, 0, 100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fusion_train_step(model, tx, True)
    step = make_fusion_train_step(model, tx, True, device="cpu")
    state = FusionTrainState.create(model.fusion, tx)
    state.step = torch.zeros((), dtype=torch.int32, device="meta")
    data = {k: torch.from_numpy(v) for k, v in batch(6).items()}
    with pytest.raises(ValueError, match="create the state after"):
        step(state, data, FUSION_SCALE)
