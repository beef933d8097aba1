"""One fusion-phase step's gradients, and their comparison leaf by leaf:
what ``chip_smoke.py`` phase 8 and the tests hold a step to (the card
against the CPU in f32; bf16 against f32).

 - ``KeepGrads``: an optimizer that applies nothing and keeps the
   gradients it was given as its state.
 - ``step_grads``: (metrics, gradients) of one step of a copy of a model.
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

from .state import FusionTrainState
from .steps import make_fusion_train_step


class KeepGrads:
    """The optimizer contract of ``make_fusion_train_step``, applying
    nothing: the new optimizer state is the gradients."""

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        return {k: g.detach().clone() for k, g in grads.items()}


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
