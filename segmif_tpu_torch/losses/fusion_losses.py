"""Fusion losses on NHWC tensors in [0, 1] (counterpart of
``segmif_tpu/losses/fusion_losses.py``). Only channel 0 (Y) of a
multi-channel input is read, as in the reference.

 - ``fusion_loss_l1_grad`` <- Fusionloss3 (round 1):
   L1(fused, mask_Y) + L1(sobel(fused), sobel(mask_Y)).
 - ``fusion_loss_mse_ssim`` <- Fusionloss_grad3 (rounds >= 2):
   MSE(fused, mask_Y) + 1.1 * (1 - SSIM).

The rest of the family (max-gradient, Laplacian pyramid, IQA) is not
ported yet.
"""
from __future__ import annotations

import torch

from ..ops.filters import sobel_magnitude
from ..ops.ssim import ssim


def _y(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0:1]


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def fusion_loss_l1_grad(ir, vis, fused_y, mask) -> torch.Tensor:
    """Round-1 fusion loss (Fusionloss3). ``ir`` and ``vis`` are unused,
    as in the reference; the signature keeps the family's."""
    target = _y(mask)
    return (l1(target, fused_y)
            + l1(sobel_magnitude(target), sobel_magnitude(fused_y)))


def fusion_loss_mse_ssim(ir, vis, fused_y, mask,
                         ssim_weight: float = 1.1) -> torch.Tensor:
    """Round >= 2 fusion loss (Fusionloss_grad3)."""
    target = _y(mask)
    return mse(target, fused_y) + ssim_weight * (1.0 - ssim(fused_y, target))
