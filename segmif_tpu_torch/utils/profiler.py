"""Spans and traces of the port (counterpart of
``segmif_tpu/utils/profiler.py``).

 - ``span(name)``: a host range around one layer's work (the serving
   call, the fusion net and its DRDBs and FFM rounds, the MiT and its
   stages, the head, the train step's phases, the kernels' recompute
   backward, the kernel library's build). When nothing reads spans it
   returns one shared no-op, at the cost of one check. Under a running
   ``torch.profiler`` it records ``segmif/<name>`` in the same trace as
   the device's kernels, on its clock. With the host accounting on
   (``spans_on``) it adds its host nanoseconds and one call to the table
   ``span_totals`` reads. While ``torch.export`` or TorchDynamo traces,
   it does nothing: the graph gains no node.
 - ``trace``: a ``torch.profiler`` trace of the block (CPU activity, and
   the card's when CUDA is available), written as a Chrome trace; the
   spans show on the host's threads, above the operators they enclose.

The range is a ``RecordFunction`` of function scope, as the profiler's
operators are, not a user annotation: the profiler then makes no
device-side copy of it, so a reading of the trace's device rows
(busy time, idle share, kernels by launching operator) is the same with
the spans as without.
"""
from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch import compiler

PREFIX = "segmif/"

_on = False                          # the host accounting
_totals: Dict[str, List[int]] = {}   # name -> [host ns, calls]
_lock = threading.Lock()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name
        self.range = None
        self.t0 = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name)
            self.range.__enter__()
        if _on:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.t0 is not None:
            ns = time.perf_counter_ns() - self.t0
            with _lock:     # the autograd engine's threads open spans too
                entry = _totals.setdefault(self.name, [0, 0])
                entry[0] += ns
                entry[1] += 1
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False


def span(name: str):
    """A context manager around the work of ``name`` (``"fusion/drdb1"``,
    ``"step/optimizer"``, ...): the shared no-op unless a profiler runs
    or the accounting is on, and outside a compiler's trace."""
    if not (_on or _autograd_profiler._is_profiler_enabled) or \
            compiler.is_compiling():
        return _NOOP
    return _Span(name)


@contextlib.contextmanager
def spans_on():
    """Host accounting on for the block: each span closed inside it adds
    its host nanoseconds and one call to the process-wide table. The table
    outlives the block; the difference of two ``span_totals`` readings is
    the stretch between them."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def span_totals() -> Dict[str, Tuple[int, int]]:
    """{name: (host ns, calls)} of every span closed with the accounting
    on, in this process, since it started. Nested spans each count their
    whole time, so a parent's total holds its children's."""
    with _lock:
        return {name: (ns, calls) for name, (ns, calls) in _totals.items()}


@contextlib.contextmanager
def trace(log_dir: str = "segmif_trace"):
    """Profile the block with ``torch.profiler``; on exit the trace is
    written to ``<log_dir>/trace.json`` (open it in Perfetto or
    chrome://tracing, where the ``segmif/`` spans show which layer the
    host was in). Yields the profiler, whose ``key_averages()`` sums the
    time by span, op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
