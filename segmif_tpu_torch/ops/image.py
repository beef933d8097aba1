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
    for upsampling, which is all the port does).

    The forward is ``F.interpolate``. When a gradient is needed and both
    factors are integers (every resize of the training path: 2, 4 and 8
    in the head, 4 for the logits, 4 and 8 for the fusion taps), the
    backward is the adjoint of ``upsample_bilinear_int`` (``_ResizeIntFn``)
    and not ``F.interpolate``'s, whose CUDA form sums with float atomics
    in an order that changes from run to run."""
    size = (int(size[0]), int(size[1]))
    factors = _int_factors(x.shape[1:3], size)
    if factors is not None and torch.is_grad_enabled() and x.requires_grad:
        return _ResizeIntFn.apply(x, factors)
    return _interpolate(x, size)


def _interpolate(x: torch.Tensor, size) -> torch.Tensor:
    return nhwc(F.interpolate(nchw(x), size=size, mode="bilinear",
                              align_corners=False, antialias=False))


def _int_factors(hw, size):
    """(sh, sw) when ``size`` is ``hw`` times whole numbers, else None."""
    if any(n <= 0 or m % n for n, m in zip(hw, size)):
        return None
    return tuple(m // n for n, m in zip(hw, size))


class _ResizeIntFn(torch.autograd.Function):
    """``F.interpolate``'s forward; the backward is the adjoint of the
    integer-factor upsample, recomputed through ``upsample_bilinear_int``
    (shifted lerps, whose backward has no atomics)."""

    @staticmethod
    def forward(ctx, x, factors):
        ctx.factors = factors
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return _interpolate(x, (x.shape[1] * factors[0],
                                x.shape[2] * factors[1]))

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.x_meta
        with torch.enable_grad():
            z = torch.zeros(shape, dtype=dtype, device=device,
                            requires_grad=True)
            y = upsample_bilinear_int(z, ctx.factors)
            gx, = torch.autograd.grad(y, z, g)
        return gx, None


def normalize_imagenet(rgb01: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB [..., 3] -> (x*255 - mean) / std, ImageNet statistics."""
    mean = const(IMAGENET_MEAN, rgb01.device, rgb01.dtype)
    std = const(IMAGENET_STD, rgb01.device, rgb01.dtype)
    return (rgb01 * 255.0 - mean) / std


def upsample_bilinear_int(x: torch.Tensor, s) -> torch.Tensor:
    """Integer-factor half-pixel bilinear upsample of [..., H, W, C] by
    ``s`` (one factor, or (sh, sw)); ``resize_bilinear``'s maths to float
    rounding, as shifted lerps: output k of each input pixel along an axis
    sits at offset f = (k + 0.5) / s - 0.5 and mixes the pixel with its
    neighbour on f's side (edge pixels repeated)."""
    sh, sw = (s, s) if isinstance(s, int) else s

    def up1(t: torch.Tensor, axis: int, s: int) -> torch.Tensor:
        n = t.shape[axis]
        prev = torch.cat([t.narrow(axis, 0, 1), t.narrow(axis, 0, n - 1)],
                         axis)
        nxt = torch.cat([t.narrow(axis, 1, n - 1), t.narrow(axis, n - 1, 1)],
                        axis)
        planes = []
        for k in range(s):
            f = (k + 0.5) / s - 0.5
            lo = -1 if f < 0 else 0
            w = f - lo
            a, b = (prev, t) if lo < 0 else (t, nxt)
            planes.append((1 - w) * a + w * b)
        y = torch.stack(planes, dim=axis + 1)
        shape = list(t.shape)
        shape[axis] *= s
        return y.reshape(shape)

    return up1(up1(x, x.dim() - 3, sh), x.dim() - 2, sw)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour resize of [..., H, W, C] (any dtype; label maps):
    output i reads input floor((i + 0.5) * n_in / n_out), computed in f32
    as ``jax.image.resize``'s nearest method computes it."""
    out = x
    for axis, n in ((x.dim() - 3, int(size[0])), (x.dim() - 2, int(size[1]))):
        m = x.shape[axis]
        if m == n:
            continue
        src = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                          * m / n).long().to(x.device)
        out = out.index_select(axis, src)
    return out


def pad_to(x: torch.Tensor, h: int, w: int, value: float = 0.0) -> torch.Tensor:
    """Bottom/right-pad [..., H, W, C] to at least (h, w) with a
    constant."""
    ph = max(h - x.shape[-3], 0)
    pw = max(w - x.shape[-2], 0)
    return F.pad(x, (0, 0, 0, pw, 0, ph), value=value)
