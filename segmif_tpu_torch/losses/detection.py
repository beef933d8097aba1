"""FCOS-style box and detection losses (counterpart of
``segmif_tpu/losses/detection.py``; the reference's dormant detection
block, ``core/loss.py:38-339``, which no entry point calls).

Boxes are [..., 4] = (x_min, y_min, x_max, y_max).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _area(box: torch.Tensor) -> torch.Tensor:
    return ((box[..., 2] - box[..., 0]).clamp_min(0.0)
            * (box[..., 3] - box[..., 1]).clamp_min(0.0))


def _inter(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    wh = (torch.minimum(a[..., 2:], b[..., 2:])
          - torch.maximum(a[..., :2], b[..., :2])).clamp_min(0.0)
    return wh[..., 0] * wh[..., 1]


def box_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7):
    """Elementwise IoU of aligned box arrays [..., 4] -> [...]."""
    inter = _inter(a, b)
    return inter / (_area(a) + _area(b) - inter + eps)


def iou_loss(pred: torch.Tensor, target: torch.Tensor,
             eps: float = 1e-7) -> torch.Tensor:
    """-log(IoU), the mean (the reference's 'iou' mode)."""
    return (-torch.log(box_iou(pred, target, eps) + eps)).mean()


def giou_loss(pred: torch.Tensor, target: torch.Tensor,
              eps: float = 1e-7) -> torch.Tensor:
    """1 - GIoU, the mean (the reference's 'giou' mode)."""
    iou = box_iou(pred, target, eps)
    hull_wh = (torch.maximum(pred[..., 2:], target[..., 2:])
               - torch.minimum(pred[..., :2], target[..., :2])).clamp_min(0.0)
    hull = hull_wh[..., 0] * hull_wh[..., 1]
    union = _area(pred) + _area(target) - _inter(pred, target)
    return (1.0 - (iou - (hull - union) / (hull + eps))).mean()


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25):
    """Binary focal loss on logits, summed (the classification term of
    the reference's ``compute_cls_loss``); targets in {0, 1}."""
    p = torch.sigmoid(logits)
    ce = F.softplus(logits) - logits * targets    # BCE with logits
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return (a_t * (1 - p_t) ** gamma * ce).sum()


def centerness_bce_loss(logits: torch.Tensor, targets: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """BCE with logits on the centerness targets over the positive
    locations ``mask`` (``compute_cnt_loss``)."""
    ce = F.softplus(logits) - logits * targets
    ce = torch.where(mask, ce, torch.zeros_like(ce))
    return ce.sum() / mask.sum().clamp_min(1)


def coords_fmap(h: int, w: int, stride: int) -> torch.Tensor:
    """Feature-map cell centres in image coordinates, [h*w, 2] as (x, y)
    (the reference's ``coords_fmap2orig``)."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32) * stride,
                            torch.arange(w, dtype=torch.float32) * stride,
                            indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], -1) + stride // 2


def gen_level_targets(shape_hw: Tuple[int, int], gt_boxes: torch.Tensor,
                      classes: torch.Tensor, stride: int, limit_range,
                      sample_radiu_ratio: float = 1.5):
    """FCOS targets of one FPN level (the reference's
    ``GenTargets._gen_level_targets``), batched: each location takes the
    positive box of smallest area (the first on a tie, as argmin picks).

    gt_boxes: [B, m, 4]; classes: [B, m] int. Returns (cls [B, hw, 1]
    int32, centerness [B, hw, 1], regression [B, hw, 4]); a location with
    no positive box gets 0 / -1 / -1."""
    h, w = shape_hw
    coords = coords_fmap(h, w, stride).to(gt_boxes.device, gt_boxes.dtype)
    x = coords[:, 0][None, :, None]                  # [1, hw, 1]
    y = coords[:, 1][None, :, None]
    ltrb = torch.stack([x - gt_boxes[..., 0][:, None, :],
                        y - gt_boxes[..., 1][:, None, :],
                        gt_boxes[..., 2][:, None, :] - x,
                        gt_boxes[..., 3][:, None, :] - y], -1)  # [B,hw,m,4]
    areas = (ltrb[..., 0] + ltrb[..., 2]) * (ltrb[..., 1] + ltrb[..., 3])
    off_min = ltrb.amin(-1)
    off_max = ltrb.amax(-1)
    in_box = off_min > 0
    in_level = (off_max > limit_range[0]) & (off_max <= limit_range[1])
    radiu = stride * sample_radiu_ratio
    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2
    c_off = torch.stack([x - cx[:, None, :], y - cy[:, None, :],
                         cx[:, None, :] - x, cy[:, None, :] - y], -1)
    near_center = c_off.amax(-1) < radiu
    mask_pos = in_box & in_level & near_center        # [B, hw, m]
    areas = torch.where(mask_pos, areas,
                        torch.full_like(areas, 99999999.0))
    best = areas.argmin(-1)                           # [B, hw]
    reg = ltrb.gather(2, best[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    cls = classes[:, None, :].expand(areas.shape).to(torch.int32).gather(
        2, best[..., None])                           # [B, hw, 1]
    lr_min = torch.minimum(reg[..., 0], reg[..., 2])
    lr_max = torch.maximum(reg[..., 0], reg[..., 2])
    tb_min = torch.minimum(reg[..., 1], reg[..., 3])
    tb_max = torch.maximum(reg[..., 1], reg[..., 3])
    cnt = torch.sqrt(((lr_min * tb_min) / (lr_max * tb_max + 1e-10))
                     .clamp_min(0.0))[..., None]
    pos = mask_pos.any(-1)[..., None]                 # [B, hw, 1]
    return (torch.where(pos, cls, torch.zeros_like(cls)),
            torch.where(pos, cnt, torch.full_like(cnt, -1.0)),
            torch.where(pos, reg, torch.full_like(reg, -1.0)))


def gen_targets(level_shapes: Sequence[Tuple[int, int]],
                gt_boxes: torch.Tensor, classes: torch.Tensor, strides,
                limit_ranges, sample_radiu_ratio: float = 1.5):
    """Multi-level FCOS targets (``GenTargets.forward``), concatenated
    over the levels."""
    outs = [gen_level_targets(s, gt_boxes, classes, st, lr,
                              sample_radiu_ratio)
            for s, st, lr in zip(level_shapes, strides, limit_ranges)]
    return tuple(torch.cat([o[i] for o in outs], 1) for i in range(3))
