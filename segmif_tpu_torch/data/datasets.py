"""Datasets (counterpart of ``segmif_tpu/data/datasets.py``).

Only ``SyntheticFusionDataset`` is ported: a numpy copy whose samples are
byte for byte the JAX package's for the same ``(n, size, num_classes,
seed)``. The folder, MFNet and VOC datasets are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


class SyntheticFusionDataset:
    """Deterministic procedurally generated IR/VIS/guide/label samples with
    MFNet-like statistics, for tests and smoke runs. ``ds[i]`` is
    ``(name, ir [H,W,3], vis [H,W,3], guide [H,W,3], label [H,W])``: the
    images float32 in [0, 255], the label int32."""

    def __init__(self, n: int = 16, size: Tuple[int, int] = (480, 640),
                 num_classes: int = 9, seed: int = 0):
        self.n = n
        self.size = size
        self.num_classes = num_classes
        self.seed = seed
        self.names = [f"synthetic_{i:05d}.png" for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        h, w = self.size
        rng = np.random.default_rng(self.seed * 100003 + i)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, 4)
        base = (np.sin(xx / 37.0 + phase[0]) + np.cos(yy / 23.0 + phase[1]))
        hot = np.maximum(np.sin(xx / 11.0 + phase[2]) *
                         np.cos(yy / 17.0 + phase[3]), 0.0)
        ir = np.clip((base * 0.25 + 0.5 + hot * 0.4) * 255.0, 0, 255)
        ir3 = np.stack([ir] * 3, -1).astype(np.float32)
        vis = np.stack([
            np.clip((base * 0.3 + 0.5) * 255.0, 0, 255),
            np.clip((base * 0.2 + 0.45) * 255.0, 0, 255),
            np.clip((-base * 0.25 + 0.5) * 255.0, 0, 255),
        ], -1).astype(np.float32)
        guide = np.clip(np.maximum(ir3, vis), 0, 255).astype(np.float32)
        label = (np.floor((hot * 2 + base + 2) * 2.0).astype(np.int32)
                 % self.num_classes)
        return self.names[i], ir3, vis, guide, label
