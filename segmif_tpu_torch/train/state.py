"""Training state (counterpart of ``segmif_tpu/train/state.py``).

``FusionTrainState`` holds what a fusion-phase step reads and writes, all
on the device: the fusion network's parameters (f32, the optimizer's
master copy; the module's own ``nn.Parameter``s, so the trained module is
the state's), the optimizer state, the DWA loss buffer and the step count.

``SegTrainState`` holds what a seg-phase step reads and writes: the
segmentation network's parameters (f32 master weights, the module's own),
its BatchNorm running buffers (the module's own; the step folds each
batch's statistics into them), the optimizer state and the step count on
the device, and the same count on the host (``host_step``), from which
the step seeds its random draws without reading the device.

Each step updates its state in place. Under tensor parallelism the
parameters are the rank's pieces of the split leaves (``splits``:
``parallel.tensor.split_leaves`` of the module), and so are the AdamW
moments.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn as nn

from ..losses.dwa import DWAState, dwa_init
from ..parallel.tensor import split_leaves


def _step0(dev) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=dev)


@dataclasses.dataclass
class FusionTrainState:
    params: Dict[str, torch.Tensor]   # trainable fusion-network params
    opt_state: Any
    dwa: DWAState
    step: torch.Tensor                # int32 scalar
    splits: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, fusion: nn.Module, tx) -> "FusionTrainState":
        """The state of ``fusion`` (already on its device, in f32) with a
        fresh optimizer state from ``tx`` (``optimizer.AdamW``)."""
        params = dict(fusion.named_parameters())
        dev = next(iter(params.values())).device
        return cls(params=params, opt_state=tx.init(params),
                   dwa=dwa_init(dev), step=_step0(dev),
                   splits=split_leaves(fusion))


@dataclasses.dataclass
class SegTrainState:
    params: Dict[str, torch.Tensor]        # trainable seg-network params
    batch_stats: Dict[str, torch.Tensor]   # BatchNorm running buffers
    opt_state: Any
    step: torch.Tensor                     # int32 scalar
    host_step: int = 0                     # the same count, on the host
    splits: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, seg: nn.Module, tx) -> "SegTrainState":
        """The state of ``seg`` (a ``SegmentationNetwork`` already on its
        device, in f32) with a fresh optimizer state from ``tx``."""
        params = dict(seg.named_parameters())
        stats = {n: b for n, b in seg.named_buffers()
                 if n.rsplit(".", 1)[-1] in ("running_mean", "running_var")}
        dev = next(iter(params.values())).device
        return cls(params=params, batch_stats=stats,
                   opt_state=tx.init(params), step=_step0(dev),
                   splits=split_leaves(seg))
