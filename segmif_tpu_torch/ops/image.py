"""Image ops on channel-last (NHWC) tensors (counterpart of
``segmif_tpu/ops/image.py``)."""
from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


@functools.lru_cache(maxsize=None)
def const(values: tuple, device: torch.device,
          dtype: torch.dtype) -> torch.Tensor:
    """A constant (nested tuples of numbers) as a tensor on ``device``,
    made once per device and dtype: a fresh ``torch.tensor(...,
    device=cuda)`` per call is a blocking host-to-device copy, which waits
    for the stream. Made outside inference mode, so that autograd may
    save it when the first caller ran under ``torch.inference_mode()``.
    Callers must not write to it."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


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
    mean = const(IMAGENET_MEAN, rgb01.device, rgb01.dtype)
    std = const(IMAGENET_STD, rgb01.device, rgb01.dtype)
    return (rgb01 * 255.0 - mean) / std
