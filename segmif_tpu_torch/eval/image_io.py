"""Writing and reading fused images (counterpart of
``segmif_tpu/eval/image_io.py``), numpy and PIL on the host.

The reference quantises twice: clip to [0, 1], truncate ``255 * x`` to
uint8, stretch the whole batch's min..max to 0..1, truncate again.
``quantize_like_reference=True`` reproduces that bit for bit; False
stretches the clipped floats and rounds once. Either way the stretch is
over the whole array handed in, so a caller passes only the real images
of a padded batch.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def fused_to_uint8(fused_rgb01: np.ndarray,
                   quantize_like_reference: bool = True) -> np.ndarray:
    """[B, H, W, 3] float in [0, 1] -> uint8 after the batch-global
    min-max stretch."""
    x = np.clip(np.asarray(fused_rgb01), 0.0, 1.0)
    if quantize_like_reference:
        x = np.uint8(255.0 * x)
        x = (x - np.min(x)) / max(float(np.max(x)) - float(np.min(x)), 1e-12)
        return np.uint8(255.0 * x)
    lo, hi = float(x.min()), float(x.max())
    x = (x - lo) / max(hi - lo, 1e-12)
    return np.uint8(np.round(255.0 * x))


def save_png(path: str | Path, img: np.ndarray) -> None:
    """Write an [H, W], [H, W, 1] or [H, W, 3] image as PNG (non-uint8
    values clipped to [0, 255] and truncated)."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if img.dtype != np.uint8:
        img = np.uint8(np.clip(img, 0, 255))
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    Image.fromarray(img).save(path)


def write_fused_batch(out_dir: str | Path, names, fused_rgb01: np.ndarray,
                      quantize_like_reference: bool = True) -> None:
    """Write each fused image of a batch as ``<out_dir>/<name>``, the
    batch quantised together (``fused_to_uint8``)."""
    imgs = fused_to_uint8(fused_rgb01, quantize_like_reference)
    for k, name in enumerate(names):
        save_png(Path(out_dir) / name, imgs[k])


def load_fused_dir(fused_dir: str | Path) -> Optional[np.ndarray]:
    """Every file of ``fused_dir`` in sorted name order as float32 in
    [0, 1], stacked; None if the directory does not exist."""
    from PIL import Image

    fused_dir = Path(fused_dir)
    if not fused_dir.exists():
        return None
    names = sorted(p.name for p in fused_dir.iterdir())
    return np.stack([
        np.asarray(Image.open(fused_dir / n)).astype(np.float32) / 255.0
        for n in names
    ])
