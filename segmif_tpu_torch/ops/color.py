"""Colour-space conversions on channel-last tensors (counterpart of
``segmif_tpu/ops/color.py``).

BT.601-style constants: Y = .299 R + .587 G + .114 B;
Cr = (R - Y) * 0.713 + 0.5; Cb = (B - Y) * 0.564 + 0.5. The inverse uses
the matrix [[1,1,1],[1.403,-.714,0],[0,-.344,1.773]].
"""
from __future__ import annotations

import torch

from .image import const

_INV_MAT = ((1.0, 1.0, 1.0), (1.403, -0.714, 0.0), (0.0, -0.344, 1.773))
_INV_BIAS = (0.0, -0.5, -0.5)


def rgb_to_ycrcb(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB in [0,1] -> [..., 3] (Y, Cr, Cb)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cr = (r - y) * 0.713 + 0.5
    cb = (b - y) * 0.564 + 0.5
    return torch.stack([y, cr, cb], dim=-1)


def ycrcb_to_rgb(ycrcb: torch.Tensor) -> torch.Tensor:
    """[..., 3] (Y, Cr, Cb) -> [..., 3] RGB (unclipped)."""
    mat = const(_INV_MAT, ycrcb.device, ycrcb.dtype)
    bias = const(_INV_BIAS, ycrcb.device, ycrcb.dtype)
    return (ycrcb + bias) @ mat


def recombine_fused(fused_y: torch.Tensor,
                    vis_ycrcb: torch.Tensor) -> torch.Tensor:
    """Replace the Y channel of a visible YCrCb image with the fused Y and
    convert to RGB, clipped to [0,1]. fused_y: [..., H, W, 1];
    vis_ycrcb: [..., H, W, 3]."""
    ycrcb = torch.cat([fused_y.to(vis_ycrcb.dtype), vis_ycrcb[..., 1:]],
                      dim=-1)
    return ycrcb_to_rgb(ycrcb).clamp(0.0, 1.0)


def minmax_stretch(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Min-max renormalisation to [0, 1] over the WHOLE tensor (every
    image of a batch together), as the reference's ``Mean`` and
    ``Fusion_Network`` stretch (``model_fusion.py:207-209``)."""
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo + eps)


def mean_recombine(mask_y: torch.Tensor, vis_rgb: torch.Tensor) -> torch.Tensor:
    """The reference's ``Mean`` module (``model_fusion.py:184-214``): the
    visible image's Y replaced by ``mask_y`` ([..., H, W, 1]), back to RGB,
    clipped, then ``minmax_stretch``ed. vis_rgb: [..., H, W, 3]."""
    vis_ycrcb = rgb_to_ycrcb(vis_rgb)
    rgb = ycrcb_to_rgb(torch.cat([mask_y.to(vis_ycrcb.dtype),
                                  vis_ycrcb[..., 1:]], dim=-1))
    return minmax_stretch(rgb.clamp(0.0, 1.0))
