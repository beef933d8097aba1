"""Segmentation losses (counterpart of ``segmif_tpu/losses/seg_loss.py``).

``cross_entropy``: torch's CrossEntropyLoss(ignore_index) on NHWC logits,
the mean over the pixels whose label is not ignored, with one difference
kept from the JAX package: when every pixel is ignored (an all-255 crop,
which real data gives) the loss is 0, not ``F.cross_entropy``'s NaN
(the sum is divided by max(count, 1)).

``ohem_cross_entropy`` (online hard example mining, the reference's
``loss.py:342-358``) and ``focal_loss`` (softmax focal loss,
``loss.py:361-374``) keep the same ignore rule.
"""
from __future__ import annotations

import torch


def _log_probs(logits: torch.Tensor, labels: torch.Tensor,
               ignore_index: int):
    """(valid mask, log p of the labelled class, 0 where ignored) in f32
    (f64 for f64 logits). The label's log p is picked by a one-hot mask
    summed over the classes (exact: one term and zeros), whose backward
    needs no scatter: ``gather``'s backward sums with float atomics on the
    card, in an order that changes from run to run."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    classes = torch.arange(logp.shape[-1], device=logp.device)
    onehot = safe.unsqueeze(-1) == classes
    return valid, torch.where(onehot, logp, torch.zeros_like(logp)).sum(-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = 255, count=None) -> torch.Tensor:
    """logits: [B, H, W, C] (any leading dims); labels: [B, H, W] int.
    Mean CE over the pixels whose label != ignore_index, in f32 (f64 for
    f64 logits). ``count`` replaces the number of those pixels as the
    divisor (the global batch's under data parallelism)."""
    valid, logpt = _log_probs(logits, labels, ignore_index)
    nll = torch.where(valid, -logpt, torch.zeros_like(logpt))
    return nll.sum() / (valid.sum() if count is None else count).clamp_min(1)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255, thresh: float = 0.7,
                       min_kept_fraction: float = 1.0 / 16.0) -> torch.Tensor:
    """The mean CE over the pixels whose loss is at least min(-log(thresh),
    the k-th largest loss), k = max(int(pixels * min_kept_fraction), 1)
    over ALL pixels, ignored ones included (they rank as -inf): so at
    least k pixels are kept when k are valid, and every valid pixel when
    fewer are. Ties at the cut are all kept; all ignored gives 0."""
    valid, logpt = _log_probs(logits, labels, ignore_index)
    nll = torch.where(valid, -logpt, torch.full_like(logpt, float("-inf")))
    nll = nll.reshape(-1)
    n_min = max(int(nll.shape[0] * min_kept_fraction), 1)
    loss_thresh = -torch.log(torch.tensor(thresh, dtype=nll.dtype,
                                          device=nll.device))
    kth = torch.topk(nll, n_min).values[-1]
    keep = (nll >= torch.minimum(loss_thresh, kth)) & torch.isfinite(nll)
    kept = torch.where(keep, nll, torch.zeros_like(nll))
    return kept.sum() / keep.sum().clamp_min(1)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               alpha: float = 0.25, ignore_index: int = 255) -> torch.Tensor:
    """Softmax focal loss alpha (1 - p)^gamma CE, the mean over the valid
    pixels (0 when all are ignored)."""
    valid, logpt = _log_probs(logits, labels, ignore_index)
    loss = -alpha * (1.0 - torch.exp(logpt)) ** gamma * logpt
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    return loss.sum() / valid.sum().clamp_min(1)
