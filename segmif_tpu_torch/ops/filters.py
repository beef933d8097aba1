"""Fixed-filter convolutions on channel-last (NHWC) tensors (counterpart of
``segmif_tpu/ops/filters.py``): the Sobel magnitude and the normalised
1-D Gaussian window.

Written as depthwise ``F.conv2d`` with zero padding. The JAX package's
banded-Toeplitz matmul form is a TPU workaround (a one-channel depthwise
conv there uses one lane in 128) and is not ported.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .image import const, nchw, nhwc

# correlation windows, as torch's F.conv2d applies them (the reference's
# Sobel convs, loss.py:634-650): gx reads right minus left, gy top minus
# bottom
_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def sobel_magnitude(x: torch.Tensor) -> torch.Tensor:
    """|sobel_x(x)| + |sobel_y(x)| for NHWC x (any channel count)."""
    c = x.shape[-1]
    k = const((_SOBEL_X, _SOBEL_Y), x.device, x.dtype)
    g = F.conv2d(nchw(x), k.repeat(c, 1, 1)[:, None], padding=1, groups=c)
    return nhwc(g[:, 0::2].abs() + g[:, 1::2].abs())


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(size: int, sigma: float) -> Tuple[float, ...]:
    """Normalised 1-D Gaussian, matlab-style (pytorch_ssim's window)."""
    xs = [math.exp(-((i - size // 2) ** 2) / (2.0 * sigma ** 2))
          for i in range(size)]
    s = sum(xs)
    return tuple(v / s for v in xs)
