"""Repeatable training on the card: the same seed gives the same losses and
weights, bit for bit, from one run to the next.

``enable(warn_only=False)`` turns on PyTorch's deterministic mode:
``torch.use_deterministic_algorithms`` (an op with no deterministic form
raises, or with ``warn_only`` warns, which lists such ops), cuDNN's
deterministic algorithms without autotuning, and the fixed cuBLAS workspace
that deterministic cuBLAS needs (``CUBLAS_WORKSPACE_CONFIG``, read at the
first cuBLAS call, so ``enable`` must run before any work on the card).

The port's own float-atomic hazards are replaced by deterministic forms
rather than exempted: the bilinear resize's backward
(``ops.image.resize_bilinear``) and the label pick of the segmentation
losses (``losses.seg_loss``). The port's kernels use no atomics.

``integer_exact()`` takes a call out of the mode: an atomic sum of integers
is exact in any order, so the mode's slower sorted form buys nothing there
(the confusion matrix's ``index_add_``, ``eval/metrics.py``, and the crop
class counts' ``scatter_add_``, ``data/augment.py``).
"""
from __future__ import annotations

import contextlib
import os

import torch

CUBLAS_WORKSPACE = ":4096:8"


def enable(warn_only: bool = False) -> None:
    """Deterministic mode for this process (see the module docstring)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


@contextlib.contextmanager
def integer_exact():
    """The block runs outside the deterministic mode (if it was on): for
    atomic sums of integers, which are exact in any order."""
    on = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    if on:
        torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        if on:
            torch.use_deterministic_algorithms(True, warn_only=warn)
