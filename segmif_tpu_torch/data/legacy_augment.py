"""MFNet-legacy augmentation (counterpart of
``segmif_tpu/data/legacy_augment.py``; the reference's
``util/augmentation.py:6-92`` and ``datasets/imutils.py:134-148``, which
no entry point calls). One image [H, W, C] float in [0, 255] and its
label [H, W] int.

The random draws are split from the maths, as in ``data.augment``: each
``draw_<op>(gen, ...)`` takes the op's random numbers from a
``torch.Generator`` and returns them as a dict, and ``<op>(image, label,
**draws, ...)`` is deterministic, so the same maths runs on draws taken
from any source.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def _u(gen: torch.Generator, shape=()) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def draw_flip(gen: torch.Generator, prob: float = 0.5) -> Dict:
    """{"do"}: the coin of ``flip`` and ``flipud``."""
    return {"do": _u(gen) < prob}


def flip(image, label, do):
    """Horizontal flip of both when ``do``."""
    return (torch.where(do, image.flip(1), image),
            torch.where(do, label.flip(1), label))


def flipud(image, label, do):
    """Vertical flip of both when ``do``."""
    return (torch.where(do, image.flip(0), image),
            torch.where(do, label.flip(0), label))


def draw_crop(gen: torch.Generator) -> Dict:
    """{"u"}: the four uniforms [4] of ``crop`` and ``crop_out``."""
    return {"u": _u(gen, (4,))}


def crop(image, label, u, crop_rate: float = 0.1):
    """Crop a margin of up to ``crop_rate`` of the size from each side
    (top, left, bottom, right from u[0..3]) and resize back to the full
    size, nearest (rounding half to even)."""
    h, w = label.shape
    dev = image.device
    top = u[0] * crop_rate * h
    left = u[1] * crop_rate * w
    bottom = h - u[2] * crop_rate * h
    right = w - u[3] * crop_rate * w
    rows = top + (bottom - top) * (torch.arange(h, device=dev) + 0.5) / h - 0.5
    cols = left + (right - left) * (torch.arange(w, device=dev) + 0.5) / w \
        - 0.5
    ri = torch.round(rows).long().clamp(0, h - 1)
    ci = torch.round(cols).long().clamp(0, w - 1)
    return image[ri][:, ci], label[ri][:, ci]


def crop_out(image, label, u, crop_rate: float = 0.2):
    """Zero a rectangle (cutout) of (u[0] crop_rate + 0.05) of the height
    by (u[1] crop_rate + 0.05) of the width, placed by u[2], u[3]."""
    h, w = label.shape
    dev = image.device
    ch = (u[0] * crop_rate + 0.05) * h
    cw = (u[1] * crop_rate + 0.05) * w
    cy = u[2] * (h - ch)
    cx = u[3] * (w - cw)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    inside = (yy >= cy) & (yy < cy + ch) & (xx >= cx) & (xx < cx + cw)
    return torch.where(inside[..., None], torch.zeros_like(image),
                       image), label


def draw_brightness(gen: torch.Generator, bright_range: float = 0.15,
                    prob: float = 0.9) -> Dict:
    """{"do", "delta"}: the coin and the factor's offset, U(-range,
    range)."""
    do = _u(gen) < prob
    return {"do": do, "delta": (_u(gen) * 2 - 1) * bright_range}


def brightness(image, label, do, delta):
    """image x (1 + delta) when ``do``, clipped to [0, 255]."""
    factor = torch.where(do, 1.0 + delta, torch.ones_like(delta))
    return (image * factor).clamp(0, 255), label


def draw_noise(gen: torch.Generator, shape: Sequence[int],
               noise_range: float = 5.0, prob: float = 0.9) -> Dict:
    """{"do", "noise"}: the coin and U(-range, range) noise of the
    image's ``shape``."""
    do = _u(gen) < prob
    return {"do": do, "noise": (_u(gen, tuple(shape)) * 2 - 1) * noise_range}


def noise(image, label, do, noise):
    """image + noise when ``do``, clipped to [0, 255]."""
    return (image + torch.where(do, noise, torch.zeros_like(noise))
            ).clamp(0, 255), label


def draw_rot(gen: torch.Generator) -> Dict:
    """{"k"}: quarter turns, uniform in {1, 2, 3}."""
    return {"k": int(torch.randint(1, 4, (), generator=gen,
                                   device=gen.device))}


def rot(image, label, k: int):
    """Rotate both by k quarter turns counter-clockwise (``np.rot90``);
    k = 1 and 3 swap H and W."""
    return (torch.rot90(image, k, dims=(0, 1)),
            torch.rot90(label, k, dims=(0, 1)))
