"""Segmentation loss (counterpart of ``segmif_tpu/losses/seg_loss.py``).

``cross_entropy``: torch's CrossEntropyLoss(ignore_index) on NHWC logits,
the mean over the pixels whose label is not ignored, with one difference
kept from the JAX package: when every pixel is ignored (an all-255 crop,
which real data gives) the loss is 0, not ``F.cross_entropy``'s NaN
(the sum is divided by max(count, 1)). OHEM and focal CE are not ported
yet.
"""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = 255) -> torch.Tensor:
    """logits: [B, H, W, C] (any leading dims); labels: [B, H, W] int.
    Mean CE over the pixels whose label != ignore_index, in f32."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp_min(1)
