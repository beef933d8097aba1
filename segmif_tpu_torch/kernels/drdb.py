"""The dilated residual dense block (DRDB), counterpart of
``segmif_tpu/kernels/pallas_drdb.py::drdb_xla``.

Five dilated (2) 3x3 convs with dense concat growth, a 1x1 bottleneck and
a residual: the plain conv chain, as the JAX default runs it. The TPU's
whole-block and tail kernels (``drdb_pallas``, ``drdb_tail_pallas``) are
still to be ported; their Hopper kernel lands here.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

Conv = Tuple[torch.Tensor, torch.Tensor]   # (OIHW weight, bias)


def drdb_chain(x: torch.Tensor, dconvs: Sequence[Conv],
               bottleneck: Conv) -> torch.Tensor:
    """x: [B, C, H, W] (NCHW view, any memory format) -> same shape."""
    feat = x
    for w, b in dconvs:
        y = F.conv2d(feat, w, b, padding=2, dilation=2)
        feat = torch.cat([feat, torch.relu(y)], dim=1)
    w, b = bottleneck
    return x + torch.relu(F.conv2d(feat, w, b))
