"""Fixed-filter convolutions on channel-last (NHWC) tensors (counterpart of
``segmif_tpu/ops/filters.py``): the Sobel magnitude, the normalised 1-D
Gaussian window, and the reference's ``smoothing`` Gaussian blur and
its same-resolution band-pass ("Laplacian") pyramid
(``lap_loss.py:39-80``).

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


def gaussian_kernel_2d_grid(size: int, sigma: float,
                            dtype: torch.dtype = torch.float32,
                            device=None) -> torch.Tensor:
    """Normalised [size, size] Gaussian on the integer grid centred at
    (size - 1) / 2, computed in ``dtype``: the ``smoothing`` kernel of the
    reference's ``lap_loss.py:39-63``."""
    coords = torch.arange(size, dtype=dtype, device=device)
    d2 = (coords - (size - 1) / 2.0) ** 2
    g = torch.exp(-(d2[:, None] + d2[None, :]) / (2.0 * sigma ** 2))
    return g / g.sum()


def gaussian_blur(x: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Gaussian blur of NHWC x with ``gaussian_kernel_2d_grid`` as a
    depthwise conv, zero padding size // 2."""
    c = x.shape[-1]
    k = gaussian_kernel_2d_grid(size, sigma, x.dtype, x.device)
    return nhwc(F.conv2d(nchw(x), k.expand(c, 1, size, size),
                         padding=size // 2, groups=c))


def unsharp_pyramid(x: torch.Tensor, sizes=(3, 5, 7), sigma: float = 2.0):
    """The reference's ``laplacian_pyramid`` (``lap_loss.py:74-80``): the
    band-pass levels x - gaussian_blur(x), one per kernel size, all at
    x's resolution."""
    return [x - gaussian_blur(x, s, sigma) for s in sizes]
