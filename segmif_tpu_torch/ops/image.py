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


def upsample_bilinear_int(x: torch.Tensor, s: int) -> torch.Tensor:
    """Integer-factor half-pixel bilinear upsample of [..., H, W, C] by
    ``s`` (``resize_bilinear``'s maths to float rounding), as shifted
    lerps: output k of each input pixel along an axis sits at offset
    f = (k + 0.5) / s - 0.5 and mixes the pixel with its neighbour on f's
    side (edge pixels repeated)."""

    def up1(t: torch.Tensor, axis: int) -> torch.Tensor:
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

    return up1(up1(x, x.dim() - 3), x.dim() - 2)


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
