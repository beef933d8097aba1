"""Training state (counterpart of ``segmif_tpu/train/state.py``).

``FusionTrainState`` holds what a fusion-phase step reads and writes, all
on the device: the fusion network's parameters (f32, the optimizer's
master copy; the module's own ``nn.Parameter``s, so the trained module is
the state's), the optimizer state, the DWA loss buffer and the step count.
The step updates it in place. ``SegTrainState`` comes with the seg step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn as nn

from ..losses.dwa import DWAState, dwa_init


@dataclasses.dataclass
class FusionTrainState:
    params: Dict[str, torch.Tensor]   # trainable fusion-network params
    opt_state: Any
    dwa: DWAState
    step: torch.Tensor                # int32 scalar

    @classmethod
    def create(cls, fusion: nn.Module, tx) -> "FusionTrainState":
        """The state of ``fusion`` (already on its device, in f32) with a
        fresh optimizer state from ``tx`` (``optimizer.AdamW``)."""
        params = dict(fusion.named_parameters())
        dev = next(iter(params.values())).device
        return cls(params=params, opt_state=tx.init(params),
                   dwa=dwa_init(dev),
                   step=torch.zeros((), dtype=torch.int32, device=dev))
