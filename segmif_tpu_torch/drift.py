"""bf16 serving held against f32 end to end.

The JAX package holds its bf16 pipeline to f32 on the TPU under the limits
of ``tests/test_bf16_drift.py:88-100``; this module applies the same limits
to the port: the same ``JointPipeline`` and weights run once in f32 and
once in bf16 (on the card, channels_last: the serving form), and the bf16
run must keep

 - the fused-Y SSIM against f32 above 0.99 (``ops.ssim``, the
   reference's 11x11 Gaussian window),
 - the fused Y within 0.02 of f32 at every pixel (Y lies in [0, 1]),
 - the segmentation argmax equal at more than 95% of the 1/4-resolution
   pixels (random-init logits hold near-ties, so agreement, not equality),
 - the logits within one standard deviation of the f32 logits.

 - ``init_reference_scale``: random weights at the reference modules'
   scale (torch's default layer init), under which the limits mean what
   they mean for a converted reference checkpoint.
 - ``pipeline_outputs``: one forward of a copy of the model in a dtype.
 - ``drift`` / ``within_limits``: the four numbers and the verdict.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, Tuple

import torch
import torch.nn as nn

from .ops.ssim import ssim

# (name, comparison, limit): the bf16 run passes when every
# `value <comparison> limit` holds
BF16_LIMITS = (("fused_y_ssim", ">", 0.99),
               ("fused_y_max_abs", "<", 0.02),
               ("argmax_agreement", ">", 0.95),
               ("logits_max_abs_per_std", "<", 1.0))


@torch.no_grad()
def init_reference_scale(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Random weights from a seeded CPU generator at the reference modules'
    scale: every conv and linear layer drawn as torch's default
    ``reset_parameters`` draws it, weight and bias U(-1/sqrt(fan_in),
    1/sqrt(fan_in)); norm scales 1 and shifts 0; PReLU 0.25. (The JAX
    initialisers, ``network.init_params``, push the fused Y to about 10,
    where a 0.02 limit means nothing.)"""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            mod.weight.copy_(
                (torch.rand(mod.weight.shape, generator=gen) * 2 - 1) * bound)
            if mod.bias is not None:
                mod.bias.copy_(
                    (torch.rand(mod.bias.shape, generator=gen) * 2 - 1)
                    * bound)
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            mod.reset_parameters()
        elif isinstance(mod, nn.PReLU):
            mod.weight.fill_(0.25)
    return model


def pipeline_outputs(model: nn.Module, ir: torch.Tensor, vis: torch.Tensor,
                     dtype: torch.dtype,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fused Y, seg logits) of one forward of a copy of ``model`` in
    ``dtype`` on ``device`` (channels_last on the card), as f32. The
    model itself is left as it was."""
    dev = torch.device(device)
    m = copy.deepcopy(model).to(dtype)
    if dev.type == "cuda":
        m.to(dev, memory_format=torch.channels_last)
    else:
        m.to(dev)
    with torch.inference_mode():
        _, fused_y, logits = m.eval()(ir.to(dev), vis.to(dev))
    return fused_y.float(), logits.float()


def drift(ref: Tuple[torch.Tensor, torch.Tensor],
          got: Tuple[torch.Tensor, torch.Tensor]) -> Dict[str, float]:
    """The four drift numbers of ``got`` (fused Y, logits) against the
    f32 ``ref``; logits are [..., classes]."""
    (y_ref, l_ref), (y, logits) = ref, got
    return {
        "fused_y_ssim": ssim(y.float(), y_ref.float()).item(),
        "fused_y_max_abs": (y - y_ref).abs().max().item(),
        "argmax_agreement": (logits.argmax(-1) == l_ref.argmax(-1)
                             ).float().mean().item(),
        "logits_max_abs_per_std": ((logits - l_ref).abs().max().item()
                                   / (l_ref.std().item() + 1e-8)),
    }


def within_limits(d: Dict[str, float]) -> bool:
    """Whether every number of ``drift`` keeps its limit."""
    return all(d[name] < lim if op == "<" else d[name] > lim
               for name, op, lim in BF16_LIMITS)


def describe(d: Dict[str, float]) -> str:
    """The numbers beside their limits, for a log line."""
    return ", ".join(f"{name} {d[name]:.5f} (limit {op} {lim:g})"
                     for name, op, lim in BF16_LIMITS)
