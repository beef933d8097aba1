"""Fusion losses on NHWC tensors in [0, 1] (counterpart of
``segmif_tpu/losses/fusion_losses.py``). Only channel 0 (Y) of a
multi-channel input is read, as in the reference.

 - ``fusion_loss_l1_grad`` <- Fusionloss3 (round 1):
   L1(fused, mask_Y) + L1(sobel(fused), sobel(mask_Y)).
 - ``fusion_loss_mse_ssim`` <- Fusionloss_grad3 (rounds >= 2):
   MSE(fused, mask_Y) + 1.1 * (1 - SSIM).

The rest of the reference's family, which no entry point calls:

 - ``fusion_loss_max_grad`` <- Fusionloss: L1 against max(IR, VIS Y) plus
   8 x the L1 of the Sobel magnitudes against their max.
 - ``fusion_loss_mask_l1`` <- Fusionloss2: L1 against the mask.
 - ``laplacian_pyramid_l1`` <- LapLoss, ``laplacian_pyramid_max_l1`` <-
   LapLoss2: weighted L1 over the band-pass levels of
   ``ops.filters.unsharp_pyramid`` (against max(IR, VIS) for LapLoss2).
 - ``fusion_loss_l1_lap`` <- Fusionloss_grad: L1 + 0.8 x LapLoss2.
 - ``fusion_loss_mse_lap_ssim`` <- Fusionloss_grad2: L1 + 0.1 x LapLoss2
   + 1.1 x (1 - SSIM).
 - ``iqa_entropy_loss`` <- IQALoss's quality term: minus the patch
   entropy per patch (``ops.entropy``).
"""
from __future__ import annotations

import torch

from ..ops.entropy import patch_entropy
from ..ops.filters import sobel_magnitude, unsharp_pyramid
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


def fusion_loss_max_grad(ir, vis, fused_y,
                         grad_weight: float = 8.0) -> torch.Tensor:
    """Max-intensity + Sobel-gradient loss (Fusionloss)."""
    iry, visy = _y(ir), _y(vis)
    loss_in = l1(torch.maximum(visy, iry), fused_y)
    grad_joint = torch.maximum(sobel_magnitude(visy), sobel_magnitude(iry))
    return loss_in + grad_weight * l1(grad_joint, sobel_magnitude(fused_y))


def fusion_loss_mask_l1(ir, vis, fused_y, mask) -> torch.Tensor:
    """Plain L1 against the mask target (Fusionloss2)."""
    return l1(_y(mask), fused_y)


def laplacian_pyramid_l1(pred, target,
                         weights=(10.0, 10.0, 1.0)) -> torch.Tensor:
    """LapLoss: weighted L1 across the band-pass levels."""
    pp, tp = unsharp_pyramid(pred), unsharp_pyramid(target)
    return sum(w * l1(a, b) for w, a, b in zip(weights, pp, tp))


def laplacian_pyramid_max_l1(fused_y, ir, vis,
                             weights=(10.0, 10.0, 1.0)) -> torch.Tensor:
    """LapLoss2: per-level L1 against the max of the IR and VIS levels."""
    fp = unsharp_pyramid(_y(fused_y))
    ip = unsharp_pyramid(_y(ir))
    vp = unsharp_pyramid(_y(vis))
    return sum(w * l1(a, torch.maximum(b, c))
               for w, a, b, c in zip(weights, fp, ip, vp))


def fusion_loss_l1_lap(ir, vis, fused_y, mask,
                       lap_weight: float = 0.8) -> torch.Tensor:
    """Fusionloss_grad: L1 against the mask + weighted LapLoss2."""
    return l1(_y(mask), fused_y) + lap_weight * laplacian_pyramid_max_l1(
        fused_y, ir, vis)


def fusion_loss_mse_lap_ssim(ir, vis, fused_y, mask, lap_weight: float = 0.1,
                             ssim_weight: float = 1.1) -> torch.Tensor:
    """Fusionloss_grad2: L1 + LapLoss2 + SSIM terms."""
    target = _y(mask)
    return (l1(target, fused_y)
            + lap_weight * laplacian_pyramid_max_l1(fused_y, ir, vis)
            + ssim_weight * (1.0 - ssim(fused_y, target)))


def iqa_entropy_loss(fused_y, patch_size: int = 4) -> torch.Tensor:
    """Minus the patch entropy per patch (higher entropy = better quality),
    the quality term of IQALoss."""
    n, h, w, _ = fused_y.shape
    num_patches = (h // patch_size) * (w // patch_size) * n
    return -patch_entropy(fused_y, patch_size=patch_size) / num_patches
