"""Dynamic task weighting (DWA-style) on the device (counterpart of
``segmif_tpu/losses/dwa.py``).

The reference keeps a host-side loss buffer and calls ``.item()`` every
step; here the last two losses per task live in device tensors and the
weighting is tensor arithmetic, so nothing waits for the device:

    w_i = loss[t-1] / loss[t-2]
    weights = 2 * softmax(w_i / temperature)
    total = weights[0] * loss_fusion * fusion_scale
          + weights[1] * loss_seg * seg_scale

For the first ``warmup_steps`` steps (reference: n_iter <= 10) the static
weights (1, 1) are used.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class DWAState(NamedTuple):
    """The last two losses per task, on the device."""
    prev: torch.Tensor    # losses at t-1, [2] f32
    prev2: torch.Tensor   # losses at t-2, [2] f32
    step: torch.Tensor    # scalar int32


def dwa_init(device=None) -> DWAState:
    return DWAState(prev=torch.ones(2, device=device),
                    prev2=torch.ones(2, device=device),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def dwa_combine(state: DWAState, loss_fusion: torch.Tensor,
                loss_seg: torch.Tensor, fusion_scale, seg_scale: float,
                temperature: float = 1000.0, warmup_steps: int = 10
                ) -> Tuple[torch.Tensor, DWAState, torch.Tensor]:
    """Returns (total loss, new state, weights [2])."""
    w_i = state.prev / state.prev2.clamp_min(1e-12)
    weights = 2.0 * torch.softmax(w_i / temperature, dim=0)
    w = torch.where(state.step > warmup_steps, weights,
                    torch.ones_like(weights))
    total = w[0] * loss_fusion * fusion_scale + w[1] * loss_seg * seg_scale
    new = DWAState(prev=torch.stack([loss_fusion, loss_seg]).float(),
                   prev2=state.prev, step=state.step + 1)
    return total, new, w
