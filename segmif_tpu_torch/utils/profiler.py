"""Tracing and timing hooks (counterpart of ``segmif_tpu/utils/profiler.py``).

 - ``trace``: a ``torch.profiler`` trace of the block (CPU activity, and
   the card's when CUDA is available), written as a Chrome trace;
 - ``StepTimer``: rolling per-step wall-clock statistics;
 - ``benchmark_fn``: mean seconds per call of a function, timed with CUDA
   events when it runs on the card and with the host clock on the CPU.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "segmif_trace"):
    """Profile the block with ``torch.profiler``; on exit the trace is
    written to ``<log_dir>/trace.json`` (open it in Perfetto or
    chrome://tracing). Yields the profiler, whose ``key_averages()``
    sums the time by op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Rolling per-step wall-clock stats; call ``tick()`` once per step.
    The host clock: a step that ends on the card must synchronise before
    its tick to be timed as the card ran it."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: list = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self.mean else 0.0


def benchmark_fn(fn: Callable, *args, iters: int = 10,
                 warmup: int = 2) -> float:
    """Mean seconds per call of ``fn(*args)`` after ``warmup`` calls, on
    the device of the first tensor in ``args``: on the card timed with
    CUDA events around the ``iters`` back-to-back calls and a synchronise,
    on the CPU (or with no tensor argument) with the host clock."""
    device = next((a.device for a in args if torch.is_tensor(a)),
                  torch.device("cpu"))
    for _ in range(warmup):
        fn(*args)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
