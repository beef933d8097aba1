"""Differentiable windowed SSIM on channel-last (NHWC) tensors (counterpart
of ``segmif_tpu/ops/ssim.py``).

The reference's pytorch_ssim: an 11x11 separable Gaussian window (sigma
1.5, normalised), zero padding window // 2 (the window is not renormalised
at the borders), C1 = 0.01^2, C2 = 0.03^2, biased variances. The five
blurs (of img1, img2, img1^2, img2^2, img1 img2) run as one depthwise
conv over the stacked planes, separably: an 11x1 pass, then a 1x11 pass.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .filters import gaussian_kernel_1d
from .image import const, nchw

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True, sigma: float = 1.5) -> torch.Tensor:
    """SSIM between NHWC images: the scalar mean (``size_average``) or the
    per-image mean [N]."""
    c = img1.shape[-1]
    win = const(gaussian_kernel_1d(window_size, sigma), img1.device,
                img1.dtype)
    pad = window_size // 2
    a, b = nchw(img1), nchw(img2)
    planes = torch.cat([a, b, a * a, b * b, a * b], dim=1)
    n = planes.shape[1]
    blur = F.conv2d(planes, win.view(1, 1, -1, 1).expand(n, 1, -1, 1),
                    padding=(pad, 0), groups=n)
    blur = F.conv2d(blur, win.view(1, 1, 1, -1).expand(n, 1, 1, -1),
                    padding=(0, pad), groups=n)
    mu1, mu2, e11, e22, e12 = blur.split(c, dim=1)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
