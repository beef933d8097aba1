"""One training step's gradients, and their comparison leaf by leaf:
what ``chip_smoke.py`` phases 8-9 and the tests hold a step to (the card
against the CPU in f32; bf16 against f32).

 - ``KeepGrads``: an optimizer that applies nothing and keeps the
   gradients it was given as its state; ``RecordGrads``: one that applies
   another and keeps the gradients beside.
 - ``step_grads``: (metrics, gradients) of one fusion step of a copy of a
   model; ``seg_step_grads``: (metrics, gradients, BatchNorm buffers, BN
   fold ratio) of one seg step of a copy of a seg network.
 - ``without_regularisers``: a copy of a seg network with drop-path and
   dropout at 0, so that two devices' steps draw nothing;
   ``exact_zero_grad``: the leaves whose exact gradient is zero in the
   train-mode seg network (their computed gradients are rounding noise).
 - ``bn_fold_ratio``: how far a step's running variance lies from flax's
   fold of the biased batch variance, in units of the step that the
   unbiased variance would add: below 1/4 where the biased one was
   folded, 1 where the unbiased one was.
 - ``leaf_errors``: per leaf, the largest |got - want| over the largest
   |want|.
 - ``leaf_cosines``: per leaf, the cosine of got and want (0 when either
   is all zeros); ``overall_cosine``: of all leaves as one vector.
 - ``norm_ratios``: per leaf, |got| / |want|.
 - ``bf16_rounded``: a copy of a model with every parameter rounded to
   bf16 and kept in f32. Its f32 step's gradients against the f32 step's
   show how far the gradient moves when only the weights are rounded, with
   no bf16 arithmetic: what a bf16 step cannot be expected to beat.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, Tuple

import torch

from ..models import segformer_head
from .state import FusionTrainState, SegTrainState
from .steps import make_fusion_train_step, make_seg_train_step


class KeepGrads:
    """The optimizer contract of ``make_fusion_train_step``, applying
    nothing: the new optimizer state is the gradients."""

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        return {k: g.detach().clone() for k, g in grads.items()}


class RecordGrads:
    """An optimizer that applies ``tx`` and keeps the gradients it was
    given (``grads``): one step gives both its gradients and its updated
    weights."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.tx.update(grads, state, params)


def step_grads(model, batch: Dict[str, torch.Tensor], round1: bool,
               compute_dtype: torch.dtype, device, fusion_scale=0.2,
               grad_accum: int = 1) -> Tuple[dict, dict]:
    """(metrics, gradients by parameter name) of one step of a copy of
    ``model`` (a ``JointPipeline``); the model is left as it was."""
    m = copy.deepcopy(model)
    tx = KeepGrads()
    step = make_fusion_train_step(m, tx, round1, grad_accum=grad_accum,
                                  compute_dtype=compute_dtype, device=device)
    state = FusionTrainState.create(m.fusion, tx)
    metrics = step(state, batch, fusion_scale)
    return metrics, state.opt_state


def without_regularisers(seg):
    """A copy of ``seg`` (a ``SegmentationNetwork``) with every drop-path
    rate and the head's dropout at 0."""
    m = copy.deepcopy(seg)
    for mod in m.modules():
        if hasattr(mod, "drop_path_rate"):
            mod.drop_path_rate = 0.0
        if hasattr(mod, "dropout_rate"):
            mod.dropout_rate = 0.0
    return m


def exact_zero_grad(name: str) -> bool:
    """The leaves whose exact gradient is zero in the train-mode seg
    network: BatchNorm subtracts each channel's batch mean, which removes
    any per-channel constant added before it, so the head's four
    projection biases and stage 4's LayerNorm bias (which reaches only
    linear_c4) have no effect on the loss."""
    return ((".linear_c" in name and name.endswith(".proj.bias"))
            or name.endswith("encoder.norm4.bias"))


def bn_fold_ratio(x: torch.Tensor, before: torch.Tensor,
                  after: torch.Tensor) -> float:
    """x: the BatchNorm's NCHW input of one step; before/after: its
    running variance around the step. The largest over channels of
    |after - (m before + (1 - m) var_b)| / ((1 - m) var_b / (n - 1)), with
    var_b the biased batch variance in f64 and n the values per channel:
    the unbiased fold reads 1, the biased one rounding only."""
    m = segformer_head.BN_MOMENTUM
    xf = x.double()
    var = xf.var(dim=(0, 2, 3), unbiased=False)
    n = x.numel() // x.shape[1]
    want = m * before.double() + (1 - m) * var
    step = (1 - m) * var / (n - 1)
    return ((after.double() - want).abs() / step).max().item()


class _CaptureBnInput:
    """While active, keeps the input of every train-mode BatchNorm."""

    def __enter__(self):
        self.real, self.inputs = segformer_head.batch_norm_train, []
        real = self.real

        def capture(x, bn, *rest):
            self.inputs.append(x.detach())
            return real(x, bn, *rest)

        segformer_head.batch_norm_train = capture
        return self

    def __exit__(self, *exc):
        segformer_head.batch_norm_train = self.real


def seg_step_grads(model, batch: Dict[str, torch.Tensor],
                   compute_dtype: torch.dtype, device,
                   seed: int = 0) -> Tuple[dict, dict, dict, float]:
    """(metrics, gradients by parameter name, BatchNorm running buffers
    after the step, ``bn_fold_ratio``) of one seg step of a copy of
    ``model`` (a ``SegmentationNetwork``); the model is left as it was."""
    m = copy.deepcopy(model)
    tx = KeepGrads()
    step = make_seg_train_step(m, tx, compute_dtype=compute_dtype,
                               device=device)
    state = SegTrainState.create(m, tx)
    var = next(v for k, v in state.batch_stats.items()
               if k.endswith("running_var"))
    before = var.clone()
    with _CaptureBnInput() as cap:
        metrics = step(state, batch, seed)
    stats = {k: v.clone() for k, v in state.batch_stats.items()}
    return (metrics, state.opt_state, stats,
            bn_fold_ratio(cap.inputs[0], before, var))


def leaf_errors(got: dict, want: dict) -> Dict[str, float]:
    """max |got - want| / max |want| per leaf (on want's device)."""
    out = {}
    for k, w in want.items():
        g = got[k].to(w.device).float()
        out[k] = ((g - w.float()).abs().max()
                  / w.float().abs().max().clamp_min(1e-30)).item()
    return out


def leaf_cosines(got: dict, want: dict) -> Dict[str, float]:
    """The cosine of each leaf's got and want, flattened; 0 when either
    is all zeros."""
    out = {}
    for k, w in want.items():
        g, w = got[k].to(w.device).double().flatten(), w.double().flatten()
        den = (g.norm() * w.norm()).item()
        out[k] = (g @ w).item() / den if den > 0 else 0.0
    return out


def overall_cosine(got: dict, want: dict) -> float:
    """The cosine of got and want with all leaves as one vector."""
    dot = nw = ng = 0.0
    for k, w in want.items():
        g, w = got[k].to(w.device).double(), w.double()
        dot += (g * w).sum().item()
        ng += g.pow(2).sum().item()
        nw += w.pow(2).sum().item()
    return dot / math.sqrt(ng * nw) if ng * nw > 0 else 0.0


def norm_ratios(got: dict, want: dict) -> Dict[str, float]:
    """|got| / |want| per leaf (inf where want is all zeros)."""
    out = {}
    for k, w in want.items():
        den = w.double().norm().item()
        num = got[k].to(w.device).double().norm().item()
        out[k] = num / den if den > 0 else math.inf
    return out


@torch.no_grad()
def bf16_rounded(model):
    """A copy of ``model`` whose parameters are rounded to bf16 and kept
    in their own dtype."""
    m = copy.deepcopy(model)
    for p in m.parameters():
        p.copy_(p.to(torch.bfloat16).to(p.dtype))
    return m
