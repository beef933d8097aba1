"""Label colormaps and image grids (counterpart of
``segmif_tpu/eval/visual.py``; the reference's tensorboard helpers in
datasets/imutils.py), numpy only. ``training_image_summary`` takes [0, 1]
RGB inputs, the pipeline's layout, where the reference un-normalised
BGR-mean-subtracted inputs."""
from __future__ import annotations

from typing import Optional

import numpy as np


def colormap(n: int = 256, normalized: bool = False) -> np.ndarray:
    """The VOC bit-interleaved palette [n, 3] (uint8, or float32 in
    [0, 1] when ``normalized``)."""
    cmap = np.zeros((n, 3), np.float32 if normalized else np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap / 255.0 if normalized else cmap


def encode_cmap(label: np.ndarray) -> np.ndarray:
    """Integer label map [..., H, W] -> RGB uint8 [..., H, W, 3]."""
    return colormap()[np.asarray(label).astype(np.int32) % 256]


def make_grid(images: np.ndarray, nrow: int = 2,
              pad: int = 2, pad_value: int = 0) -> np.ndarray:
    """Tile [B, H, W, C] images into one grid image, ``nrow`` per row."""
    images = np.asarray(images)
    b, h, w, c = images.shape
    ncol = (b + nrow - 1) // nrow
    grid = np.full((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c),
                   pad_value, images.dtype)
    for i in range(b):
        r, col = divmod(i, nrow)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = images[i]
    return grid


def training_image_summary(inputs_rgb01: np.ndarray,
                           logits: Optional[np.ndarray] = None,
                           labels: Optional[np.ndarray] = None,
                           nrow: int = 2):
    """(inputs_grid, preds_grid, labels_grid) uint8 RGB grids. logits:
    [B, H, W, K] (argmax taken here) or None; labels: [B, H, W] or
    None."""
    inputs = np.clip(np.asarray(inputs_rgb01) * 255.0, 0, 255).astype(
        np.uint8)
    grid_in = make_grid(inputs, nrow)
    grid_pred = grid_lab = None
    if logits is not None:
        preds = np.argmax(np.asarray(logits), axis=-1)
        grid_pred = make_grid(encode_cmap(preds), nrow)
    if labels is not None:
        grid_lab = make_grid(encode_cmap(np.asarray(labels)), nrow)
    return grid_in, grid_pred, grid_lab
