"""Image ops on channel-last (NHWC) tensors (counterpart of
``segmif_tpu/ops/image.py``)."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view."""
    return x.permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of [B, H, W, C] to [B, size[0], size[1], C] with
    half-pixel centres and no antialiasing (``jax.image.resize`` bilinear
    for upsampling, which is all the serving path does)."""
    out = F.interpolate(nchw(x), size=(int(size[0]), int(size[1])),
                        mode="bilinear", align_corners=False, antialias=False)
    return nhwc(out)


def normalize_imagenet(rgb01: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB [..., 3] -> (x*255 - mean) / std, ImageNet statistics."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=rgb01.dtype, device=rgb01.device)
    std = torch.tensor(IMAGENET_STD, dtype=rgb01.dtype, device=rgb01.device)
    return (rgb01 * 255.0 - mean) / std
