"""SegFormer all-MLP decode head in PyTorch (counterpart of
``segmif_tpu/models/segformer_head.py``).

Per-stage linear projection to the embedding dim, bilinear upsample of
stages 2-4 to 1/4 resolution, concat in [c4, c3, c2, c1] order, 1x1 conv +
BatchNorm (running statistics, eps 1e-5) + ReLU, and a 1x1 class conv.
Inference only: dropout is off. Module names follow the reference state
dict (``linear_c4.proj``, ``linear_fuse.conv``, ``linear_fuse.bn``,
``linear_pred``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.image import nchw, nhwc, resize_bilinear


class MLP(nn.Module):
    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Linear(in_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class ConvModule(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5)


class SegFormerHead(nn.Module):
    def __init__(self, in_dims: Sequence[int], num_classes: int,
                 embedding_dim: int = 256):
        super().__init__()
        for i, d in enumerate(in_dims):
            setattr(self, f"linear_c{i + 1}", MLP(d, embedding_dim))
        self.linear_fuse = ConvModule(4 * embedding_dim, embedding_dim)
        self.linear_pred = nn.Conv2d(embedding_dim, num_classes, 1)

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        """features: [c1, c2, c3, c4] NHWC -> logits at 1/4 res, NHWC."""
        tgt = features[0].shape[1:3]
        proj = []
        for i in (4, 3, 2, 1):
            p = getattr(self, f"linear_c{i}")(features[i - 1])
            if p.shape[1:3] != tgt:
                p = resize_bilinear(p, tgt)
            proj.append(p)
        x = self.linear_fuse.conv(nchw(torch.cat(proj, dim=-1)))
        bn = self.linear_fuse.bn
        x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, training=False, eps=bn.eps)
        return nhwc(self.linear_pred(torch.relu(x)))
