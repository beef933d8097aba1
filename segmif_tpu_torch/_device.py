"""Where the port's entry points run (``serving`` and ``train.steps``).

Each entry point runs on the card unless the caller asks for the CPU:
``device=None`` means ``cuda`` and raises when there is no CUDA device;
``device="cpu"`` runs on the CPU through the kernels' plain versions.
Nothing falls back from the card to the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """``cuda`` unless another device is named; raises when CUDA is asked
    for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the entry points run on the "
                           "card; pass device='cpu' to run on the CPU")
    return dev


def place(module: torch.nn.Module, dev: torch.device) -> torch.nn.Module:
    """Move ``module`` to ``dev``: channels_last on the card (the fusion
    trunk's layout, which the kernels read), as it is on the CPU."""
    if dev.type == "cuda":
        return module.to(dev, memory_format=torch.channels_last)
    return module.to(dev)


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``dev``. To the card through pinned
    memory and a non-blocking copy, so that the host does not wait for the
    work already queued on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)
