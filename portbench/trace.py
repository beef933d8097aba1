"""The benchmark's own spans and the reading of a device trace.

Spans: ``ranges(modules)`` opens a ``torch.profiler.record_function``
range named ``pb:<layer>`` around each forward of the given modules (by
forward hooks), and ``span(name)`` one around a call the driver makes.
They cost nothing outside a profiled stretch: the hooks are installed for
the stretch only.

``Profile`` records a bounded stretch with ``torch.profiler`` (CPU and
CUDA activity, the operators' input shapes) and reduces it, in the
process that ran it, to a picklable ``dict``:

 - ``kernels``: one row per device operation (kernel, copy, set):
   ``[name, start_us, end_us, op, shapes, dtypes, layer, backward,
   call]``, where
   ``op`` is the innermost operator or range open on the host when it was
   launched (matched by the profiler's correlation id), ``shapes`` and
   ``dtypes`` that operator's recorded inputs, ``layer`` the innermost
   ``pb:`` range around the launch ("" outside any) and ``backward`` the
   autograd node of the three kernel Functions whose backward launched it
   ("" otherwise), and ``call`` the launching operator's correlation id
   (one ``segmif::`` call may launch several kernels);
 - ``window_us``: the stretch's length by the host's clock.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

import torch

from .yardstick.classes import busy_us, kernel_class

RECOMPUTE_NODES = ("_SrAttentionFnBackward", "_CrossPathFnBackward",
                   "_DrdbFnBackward")

NAME, START, END, OP, SHAPES, DTYPES, LAYER, BACKWARD, CALL = range(9)


@contextlib.contextmanager
def ranges(modules: Dict[str, Iterable[torch.nn.Module]]):
    """``pb:<layer>`` ranges around the forwards of each layer's modules,
    for the duration of the block."""
    from torch.autograd.profiler import record_function

    handles = []
    for layer, mods in modules.items():
        for mod in mods:
            stack: List = []

            def pre(_m, _a, layer=layer, stack=stack):
                rf = record_function("pb:" + layer)
                rf.__enter__()
                stack.append(rf)

            def post(_m, _a, _o, stack=stack):
                stack.pop().__exit__(None, None, None)

            handles.append(mod.register_forward_pre_hook(pre))
            handles.append(mod.register_forward_hook(post))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def span(name: str):
    """A ``pb:<name>`` range around a call the driver makes."""
    from torch.autograd.profiler import record_function

    return record_function("pb:" + name)


class Profile:
    """One profiled stretch on the current device. ``start`` and ``stop``
    bracket it; the caller synchronises the device before each, so the
    stretch holds whole units of work. ``warm_up`` runs the profiler once
    over nothing, so that its first start (CUPTI's) falls in the set-up."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, record_shapes=True)
        self._t0 = None
        self.window_us = 0.0

    @staticmethod
    def warm_up() -> None:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        """End the stretch (the caller synchronised first); its reading
        waits for ``result``, after the window."""
        self.window_us = (time.perf_counter() - self._t0) * 1e6
        self._prof.stop()

    def result(self) -> Dict:
        return reduce_events(self._prof.profiler.kineto_results.events(),
                             self.window_us)


def _ns(e, which: str) -> float:
    f = getattr(e, which + "_ns", None)
    if f is not None:
        return float(f())
    if which == "start":
        return float(e.start_us()) * 1e3
    return float(e.start_us() + e.duration_us()) * 1e3


def reduce_events(events, window_us: float) -> Dict:
    """The stretch's kineto events as the rows described above."""
    from torch.autograd import DeviceType

    front: Dict[int, list] = {}
    by_thread: Dict[int, list] = defaultdict(list)
    device = []
    for e in events:
        dt = e.device_type()
        if dt == DeviceType.CPU:
            if e.linked_correlation_id() == 0 and e.correlation_id() > 0:
                row = [e.name(), _ns(e, "start"), _ns(e, "end"), None,
                       [list(s) for s in e.shapes()], list(e.dtypes())]
                front[e.correlation_id()] = row
                by_thread[e.start_thread_id()].append(row)
        elif dt == DeviceType.CUDA and not e.name().startswith("pb:"):
            device.append(e)   # not the device-side copy of a pb: range
    # each host event's parent: the innermost event of its thread around it
    for rows in by_thread.values():
        rows.sort(key=lambda r: (r[1], -r[2]))
        stack: List[list] = []
        for r in rows:
            while stack and stack[-1][2] < r[2]:
                stack.pop()
            r[3] = stack[-1] if stack else None
            stack.append(r)
    out = []
    t_min = min((_ns(e, "start") for e in device), default=0.0)
    for e in device:
        op = front.get(e.linked_correlation_id())
        layer = backward = ""
        p = op
        while p is not None:
            name = p[0]
            if not layer and name.startswith("pb:"):
                layer = name[3:]
            if not backward and "evaluate_function" in name:
                backward = next((n for n in RECOMPUTE_NODES if n in name), "")
            p = p[3]
        out.append([e.name(), (_ns(e, "start") - t_min) / 1e3,
                    (_ns(e, "end") - t_min) / 1e3,
                    op[0] if op else "", op[4] if op else [],
                    op[5] if op else [], layer, backward,
                    e.linked_correlation_id()])
    out.sort(key=lambda r: r[START])
    return {"kernels": out, "window_us": window_us}


# --------------------------------------------------------------- readings

def busy_s(trace: Dict) -> float:
    return busy_us([(k[START], k[END]) for k in trace["kernels"]]) / 1e6


def device_s_where(trace: Dict, pred) -> float:
    return sum(k[END] - k[START] for k in trace["kernels"] if pred(k)) / 1e6


def breakdown(traces: List[Dict], top: int = 10) -> Dict:
    """Device seconds by kernel class and idle seconds by what the host
    launched after each gap, averaged over the chips."""
    ops: Dict[str, float] = defaultdict(float)
    gaps: Dict[str, float] = defaultdict(float)
    n = len(traces)
    for tr in traces:
        for k in tr["kernels"]:
            cls = kernel_class(k[NAME])
            if cls == "other" and "nccl" in k[NAME].lower():
                cls = "NCCL collectives"
            ops[cls] += (k[END] - k[START]) / 1e6 / n
        end = None
        for k in tr["kernels"]:
            if end is not None and k[START] > end:
                where = k[OP] or k[NAME][:40]
                if k[LAYER]:
                    where += f" in pb:{k[LAYER]}"
                gaps["before " + where] += (k[START] - end) / 1e6 / n
            end = k[END] if end is None else max(end, k[END])
    order = lambda d: [[k, v] for k, v in  # noqa: E731
                       sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": order(ops), "idle_gaps": order(gaps)}


def roofline_share(traces: List[Dict]) -> Optional[float]:
    """Percent: the sum over the stretch's ``segmif::`` calls of each
    call's bound over the sum of their device times (the kernels each
    call launched). None without such a call."""
    from .yardstick.roofline import op_bound_ms

    calls: Dict[tuple, list] = {}
    for tr_i, tr in enumerate(traces):
        for k in tr["kernels"]:
            if k[OP].startswith("segmif::"):
                key = (tr_i, k[CALL])
                c = calls.setdefault(key, [k[OP], k[SHAPES], k[DTYPES], 0.0])
                c[3] += (k[END] - k[START]) / 1e3
    bound = spent = 0.0
    for op, shapes, dtypes, ms in calls.values():
        b = op_bound_ms(op, shapes, dtypes)
        if b is None:
            continue
        bound += b[0]
        spent += ms
    return 100.0 * bound / spent if spent > 0 else None


class TracedRun:
    """What a traced run hands the per-layer metrics: the profiled
    stretch of each chip (``traces``), the units of work in it (batches or
    steps, per chip), the pairs in a unit (the global batch), the model
    FLOPs of a pair, the chips, and by the host's clock the time of each
    call into the program outside the stretch (``dispatch_ms``) and the
    pairs completed and seconds spent outside it."""

    def __init__(self, kind: str, traces: List[Dict], units: int,
                 pairs_per_unit: int, flops_per_pair: float, chips: int,
                 dispatch_ms: List[float], pairs_outside: int,
                 seconds_outside: float):
        self.kind = kind
        self.traces = traces
        self.units = units
        self.pairs_per_unit = pairs_per_unit
        self.flops_per_pair = flops_per_pair
        self.chips = chips
        self.dispatch_ms = dispatch_ms
        self.pairs_outside = pairs_outside
        self.seconds_outside = seconds_outside

    def busy_s(self) -> float:
        return sum(busy_s(t) for t in self.traces) / len(self.traces)

    def window_s(self) -> float:
        return sum(t["window_us"] for t in self.traces) / 1e6 / len(
            self.traces)

    def per_unit_ms(self, pred) -> Optional[float]:
        """Device ms per unit of the rows ``pred`` keeps, averaged over the
        chips; None when no row matches."""
        if not self.units or not any(pred(k) for t in self.traces
                                     for k in t["kernels"]):
            return None
        total = sum(device_s_where(t, pred) for t in self.traces)
        return total * 1e3 / len(self.traces) / self.units

    def breakdown(self) -> Dict:
        return breakdown(self.traces)
