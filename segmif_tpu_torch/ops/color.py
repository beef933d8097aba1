"""Colour-space conversions on channel-last tensors (counterpart of
``segmif_tpu/ops/color.py``).

BT.601-style constants: Y = .299 R + .587 G + .114 B;
Cr = (R - Y) * 0.713 + 0.5; Cb = (B - Y) * 0.564 + 0.5. The inverse uses
the matrix [[1,1,1],[1.403,-.714,0],[0,-.344,1.773]].
"""
from __future__ import annotations

import torch

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
    mat = torch.tensor(_INV_MAT, dtype=ycrcb.dtype, device=ycrcb.device)
    bias = torch.tensor(_INV_BIAS, dtype=ycrcb.dtype, device=ycrcb.device)
    return (ycrcb + bias) @ mat


def recombine_fused(fused_y: torch.Tensor,
                    vis_ycrcb: torch.Tensor) -> torch.Tensor:
    """Replace the Y channel of a visible YCrCb image with the fused Y and
    convert to RGB, clipped to [0,1]. fused_y: [..., H, W, 1];
    vis_ycrcb: [..., H, W, 3]."""
    ycrcb = torch.cat([fused_y.to(vis_ycrcb.dtype), vis_ycrcb[..., 1:]],
                      dim=-1)
    return ycrcb_to_rgb(ycrcb).clamp(0.0, 1.0)
