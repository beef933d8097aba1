"""SegFormer all-MLP decode head in PyTorch (counterpart of
``segmif_tpu/models/segformer_head.py``).

Per-stage linear projection to the embedding dim, bilinear upsample of
stages 2-4 to 1/4 resolution, concat in [c4, c3, c2, c1] order, 1x1 conv +
BatchNorm (eps 1e-5) + ReLU, dropout, and a 1x1 class conv. Module names
follow the reference state dict (``linear_c4.proj``, ``linear_fuse.conv``,
``linear_fuse.bn``, ``linear_pred``).

By default (``train=False``) BatchNorm reads its running statistics and
dropout is off. With ``train=True``, as flax's ``BatchNorm(momentum=0.9)``
and ``Dropout`` in the JAX head:
 - BatchNorm normalises with the batch's own mean and *biased* variance
   (E[x^2] - E[x]^2, clipped at 0), computed in f32 (f64 for f64 inputs)
   whatever the activations' dtype, and folds them into the running
   buffers under no_grad: running = 0.9 running + 0.1 batch. (torch's
   ``F.batch_norm(training=True)`` would fold the unbiased variance.)
 - dropout keeps each element with probability 1 - rate (a mask from the
   caller's ``torch.Generator``) and scales the kept ones by 1 / keep.
Under data parallelism ``gen`` is the step's ``parallel.mesh.BatchShard``:
the statistics are the global batch's and the masks the global draws'
rows.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import _build
from ..ops.image import nchw, nhwc, resize_bilinear
from ..utils.profiler import span
from .mit import uniform

BN_MOMENTUM = 0.9


def batch_stats(x: torch.Tensor, shard=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of NCHW ``x``, in f32 (f64
    for f64 x), as flax computes them (the fast form, clipped at 0).
    Under data parallelism (``shard``, a ``parallel.mesh.BatchShard``)
    those of the global batch: the sums, the sums of squares and the
    counts of every rank, summed over the ranks through autograd, as
    GSPMD's global mean does in the JAX step."""
    xf = x.to(_build.acc_dtype(x.dtype))
    if shard is None:
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
    else:
        c = x.shape[1]
        sums = shard.sum(torch.cat([
            xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
            xf.new_full((1,), x.numel() // c)]))
        mean, mean2 = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
    return mean, (mean2 - mean * mean).clamp_min(0.0)


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor,
                         var: torch.Tensor, count: int) -> None:
    """Fold one batch's statistics into ``bn``'s running buffers (kept in
    their own dtype). ``var`` is the biased variance, as flax folds it;
    ``count``, the values per channel, is there for a check that plants
    the unbiased one."""
    m = BN_MOMENTUM
    for buf, new in ((bn.running_mean, mean), (bn.running_var, var)):
        buf.copy_(m * buf + (1 - m) * new.to(buf.dtype))


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d,
                     shard=None) -> torch.Tensor:
    """Train-mode BatchNorm of NCHW ``x`` with the batch's statistics
    (which carry the gradient; the global batch's under ``shard``) and
    the running buffers updated."""
    mean, var = batch_stats(x, shard)
    update_running_stats(bn, mean.detach(), var.detach(),
                         x.numel() // x.shape[1])
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


def dropout_mask(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    """Keep (True) / drop draws shaped like ``x``: uniform < 1 - rate,
    from ``gen`` (``mit.uniform``)."""
    return uniform(x.shape, gen, x.device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float, mask: torch.Tensor) -> torch.Tensor:
    """Dropout with a drawn mask, as flax applies it."""
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


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
                 embedding_dim: int = 256, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        for i, d in enumerate(in_dims):
            setattr(self, f"linear_c{i + 1}", MLP(d, embedding_dim))
        self.linear_fuse = ConvModule(4 * embedding_dim, embedding_dim)
        self.linear_pred = nn.Conv2d(embedding_dim, num_classes, 1)

    def forward(self, features: Sequence[torch.Tensor], train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """features: [c1, c2, c3, c4] NHWC -> logits at 1/4 res, NHWC.
        ``train=True``: batch statistics and dropout (masks from ``gen``)."""
        with span("seg/head"):
            tgt = features[0].shape[1:3]
            proj = []
            for i in (4, 3, 2, 1):
                p = getattr(self, f"linear_c{i}")(features[i - 1])
                if p.shape[1:3] != tgt:
                    p = resize_bilinear(p, tgt)
                proj.append(p)
            x = self.linear_fuse.conv(nchw(torch.cat(proj, dim=-1)))
            bn = self.linear_fuse.bn
            if not train:
                x = F.batch_norm(x, bn.running_mean, bn.running_var,
                                 bn.weight, bn.bias, training=False,
                                 eps=bn.eps)
                return nhwc(self.linear_pred(torch.relu(x)))
            shard = None if isinstance(gen, torch.Generator) else gen
            x = torch.relu(batch_norm_train(x, bn, shard))
            if self.dropout_rate > 0.0:
                if gen is None:
                    raise ValueError("dropout in train mode needs a "
                                     "generator")
                x = dropout(x, self.dropout_rate,
                            dropout_mask(x, self.dropout_rate, gen))
            return nhwc(self.linear_pred(x))
