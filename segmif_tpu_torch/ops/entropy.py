"""Differentiable patch entropy from soft (Gaussian-kernel) histograms on
NHWC tensors (counterpart of ``segmif_tpu/ops/entropy.py``; the
reference's ``core/Entropy.py``).

The image is cut into non-overlapping psize x psize patches; each
patch's pdf over ``num_bins`` points in [0, 1] is estimated with a
Gaussian kernel of width ``sigma``, and -p log p is summed over the bins
and the patches.
"""
from __future__ import annotations

import torch


def patch_entropy(x: torch.Tensor, patch_size: int = 4, num_bins: int = 32,
                  sigma: float = 0.01) -> torch.Tensor:
    """x: [N, H, W, C] (the C values of a pixel join its patch's samples).
    Returns the scalar total entropy. Rows and columns past the last whole
    patch are dropped, as the reference's ``Unfold`` drops them."""
    n, h, w, c = x.shape
    ph, pw = h // patch_size, w // patch_size
    x = x[:, :ph * patch_size, :pw * patch_size, :]
    patches = x.reshape(n, ph, patch_size, pw, patch_size, c)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(
        n * ph * pw, patch_size * patch_size * c)
    bins = torch.linspace(0.0, 1.0, num_bins, dtype=x.dtype, device=x.device)
    residuals = patches[:, :, None] - bins[None, None, :]
    pdf = torch.exp(-0.5 * (residuals / sigma) ** 2).mean(dim=1)
    # the reference's eps 1e-40 is subnormal in f32; 1e-12, as the JAX
    # package, keeps log(pdf) finite
    eps = 1e-12
    pdf = pdf / (pdf.sum(dim=1, keepdim=True) + eps) + eps
    return -(pdf * torch.log(pdf)).sum()
