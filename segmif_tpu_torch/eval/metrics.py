"""Segmentation metrics (counterpart of ``segmif_tpu/eval/metrics.py``):
the confusion matrix on the device, and the scores derived from it in
numpy on the host.

The confusion matrix is a bincount written as ``index_add_`` into a
fixed-length histogram: ``torch.bincount`` reads its input's largest
value back to the host to size its output, which would wait for the
device on every eval batch.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils.determinism import integer_exact


def confusion_matrix(label_true: torch.Tensor, label_pred: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """[num_classes, num_classes] int64 histogram on the labels' device;
    rows = true, cols = pred. Entries whose true label lies outside
    [0, num_classes) (the ignore label 255) are dropped, as _fast_hist
    drops them; predictions are clipped into range."""
    c = num_classes
    t = label_true.reshape(-1).long()
    p = label_pred.reshape(-1).long().to(t.device)
    valid = (t >= 0) & (t < c)
    idx = torch.where(valid, t * c + p.clamp(0, c - 1),
                      torch.full_like(t, c * c))
    hist = torch.zeros(c * c + 1, dtype=torch.int64, device=t.device)
    with integer_exact():   # exact in any order
        hist.index_add_(0, idx, torch.ones_like(idx))
    return hist[:-1].reshape(c, c)


def scores(hist: np.ndarray) -> Dict:
    """Pixel acc / mean acc / mIoU / per-class IoU from a confusion matrix
    (utils/eval_seg.py's, with its valid-row filter for the mean IoU)."""
    hist = np.asarray(hist, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0)
                              - np.diag(hist))
        valid = hist.sum(axis=1) > 0
        mean_iu = np.nanmean(iu[valid])
    return {
        "Pixel Accuracy": acc,
        "Mean Accuracy": acc_cls,
        "Mean IoU": mean_iu,
        "Class IoU": dict(zip(range(hist.shape[0]), iu)),
    }


def compute_results(conf_total: np.ndarray):
    """(precision_per_class, recall_per_class, iou_per_class), NaN where a
    class is absent (util/util.py's, class 0 included)."""
    conf_total = np.asarray(conf_total, dtype=np.float64)
    n_class = conf_total.shape[0]
    precision = np.full(n_class, np.nan)
    recall = np.full(n_class, np.nan)
    iou = np.full(n_class, np.nan)
    for cid in range(n_class):
        col = conf_total[:, cid].sum()
        row = conf_total[cid, :].sum()
        tp = conf_total[cid, cid]
        if col != 0:
            precision[cid] = tp / col
        if row != 0:
            recall[cid] = tp / row
        denom = row + col - tp
        if denom != 0:
            iou[cid] = tp / denom
    return precision, recall, iou


MFNET_CLASS_NAMES = (
    "unlabeled", "car", "person", "bike", "curve", "car_stop", "guardrail",
    "color_cone", "bump",
)

# 9-class MFNet palette (RGB), the reference's util/util.py:8-19
MFNET_PALETTE = np.array(
    [(0, 0, 0), (64, 0, 128), (64, 64, 0), (0, 128, 192), (0, 0, 192),
     (128, 128, 0), (64, 64, 128), (192, 128, 128), (192, 64, 0)],
    dtype=np.uint8)


def colorize_labels(label: np.ndarray,
                    palette: np.ndarray = MFNET_PALETTE) -> np.ndarray:
    """Int label map [H, W] -> RGB uint8 [H, W, 3] by palette lookup, the
    labels clipped into the palette."""
    label = np.clip(np.asarray(label, dtype=np.int64), 0, len(palette) - 1)
    return palette[label]
