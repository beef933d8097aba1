#!/usr/bin/env python3
"""What the port's spans (``segmif_tpu_torch.utils.profiler``) read in the
benchmark's one-card cells. Run on a host with one CUDA card, from the
root of the repository:

    python3 experiments/torch_spans.py [--cells b3_vga_serve_b8 ...]
        [--seed N] [--seconds S] [--repeats R] [--out FILE]

First the spans' own cost on this host: a span with nothing reading it,
with the host accounting on, and under a running ``torch.profiler``; and
whether the profiler makes device-side copies of the ``segmif/`` ranges
(a reading of the device rows must not see them). Then, per cell, the
benchmark's own set-up and closed loop (``portbench.drivers``), from the
seed:

 - ``R`` pairs of windows of ``S`` seconds, accounting off then on: the
   host ms a unit (batch or step) of the program's call in each
   (``host_dispatch_ms``, as the benchmark times it) and, with the
   accounting on, each span's host ms a unit; in training also the
   allocator's ``num_device_alloc`` + ``num_device_free`` a step;
 - ``R`` profiled stretches (the cell's ``trace_batches`` or
   ``trace_steps``, CPU and CUDA activity, no accounting): the device's
   idle time split by the innermost span the host's main thread was in
   (the share inside ``seg/encoder`` or ``seg/head``), and the device ms
   a unit of the kernels launched inside each span (the innermost span
   around the launching operator, on the launching thread);
 - in training, each span's host ms in steps that start on an idle
   device, the synchronising calls of one step and where the first one
   is, and the host ms of an AdamW update alone on an idle device.

Prints one JSON line a cell and one for the costs, and writes them all to
``--out`` (default ``artifacts/torch_spans.json``).
"""
import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, state  # noqa: E402
from portbench.drivers import serve_closed, train_fusion  # noqa: E402
from portbench.program import DTYPES, build_model  # noqa: E402
from portbench.trace import _ns  # noqa: E402
from segmif_tpu_torch.utils import profiler  # noqa: E402

MIT = "seg/"       # the seg net's spans: seg/encoder, its stages, seg/head
WINDOW = "probe/window"


def costs(dev) -> dict:
    """µs a span on this host: off, with the accounting on, under the
    profiler; and the device-side ``segmif/`` copies in a profiled
    stretch (0 expected) beside the benchmark's own ``pb:`` range's."""
    from torch.profiler import ProfilerActivity, profile

    def per_span(n):
        t = time.perf_counter()
        for _ in range(n):
            with profiler.span("fusion/drdb1"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    out = {"off_us": min(per_span(200_000) for _ in range(3))}
    with profiler.spans_on():
        out["accounting_us"] = min(per_span(200_000) for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["profiled_us"] = per_span(20_000)
    x = torch.zeros(1 << 20, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiler.span("probe"):
            x.add_(1)
        with torch.autograd.profiler.record_function("pb:probe"):
            x.add_(1)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    dev_names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
    out["device_copies_segmif"] = sum(n.startswith(profiler.PREFIX)
                                      for n in dev_names)
    out["device_copies_pb"] = sum(n.startswith("pb:") for n in dev_names)
    return out


def _delta(before, after):
    return {n: (ns - before.get(n, (0, 0))[0], c - before.get(n, (0, 0))[1])
            for n, (ns, c) in after.items()
            if c != before.get(n, (0, 0))[1]}


def _spans_ms(before, after, units):
    return {n: ns / 1e6 / units for n, (ns, _) in
            sorted(_delta(before, after).items())}


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, units) -> dict:
    """The stretch's device idle time by the main thread's innermost span,
    and device ms a unit by the innermost span around each kernel's
    launching operator ("" outside the program's spans)."""
    from torch.autograd import DeviceType

    cpu, kernels = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() == 0:
                cpu.append((_ns(e, "start"), _ns(e, "end"), e.name(),
                            e.start_thread_id(), e.correlation_id()))
        elif e.device_type() == DeviceType.CUDA and not \
                e.name().startswith(("pb:", profiler.PREFIX)):
            kernels.append((_ns(e, "start"), _ns(e, "end"),
                            e.linked_correlation_id()))
    spans = collections.defaultdict(list)     # thread -> [(s, e, name)]
    by_corr = {}
    for s, e, name, tid, corr in cpu:
        if name.startswith(profiler.PREFIX):
            spans[tid].append((s, e, name[len(profiler.PREFIX):]))
        if corr:
            by_corr[corr] = (s, tid)

    # the stretch, and the main thread: the one that holds it
    main_tid, t0_ns, t1_ns = next((tid, s, e) for tid, ss in spans.items()
                                  for s, e, name in ss if name == WINDOW)

    def innermost(tid, t):
        best = None
        for s, e, name in spans.get(tid, ()):
            if s <= t < e and (best is None or s >= best[0]):
                best = (s, name)
        return "" if best is None or best[1] == WINDOW else best[1]

    device_ms = collections.defaultdict(float)
    for s, e, corr in kernels:
        launch = by_corr.get(corr)
        name = innermost(launch[1], launch[0]) if launch else ""
        device_ms[name] += (e - s) / 1e6 / units
    busy = _union([(max(s, t0_ns), min(e, t1_ns)) for s, e, _ in kernels
                   if e > t0_ns and s < t1_ns])
    gaps, t = [], t0_ns
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < t1_ns:
        gaps.append((t, t1_ns))
    # split each gap at the main thread's span edges
    main = sorted(spans.get(main_tid, ()))
    edges = sorted({x for s, e, _ in main for x in (s, e)})
    idle = collections.defaultdict(float)
    for gs, ge in gaps:
        cuts = [gs] + [x for x in edges if gs < x < ge] + [ge]
        for a, b in zip(cuts, cuts[1:]):
            idle[innermost(main_tid, (a + b) / 2)] += (b - a) / 1e6
    idle_total = sum(idle.values())
    in_mit = sum(v for k, v in idle.items() if k.startswith(MIT))
    window_ms = (t1_ns - t0_ns) / 1e6
    return {"window_ms": window_ms, "launches": len(kernels) / units,
            "device_idle_share": 100.0 * idle_total / window_ms,
            "idle_in_mit_share": 100.0 * in_mit / idle_total
            if idle_total else None,
            "idle_ms_by_span": dict(sorted(idle.items(),
                                           key=lambda kv: -kv[1])),
            "device_ms_by_span": dict(sorted(device_ms.items(),
                                             key=lambda kv: -kv[1]))}


def _profiled(run_units, units, dev):
    """Profile ``run_units`` (then a synchronise) inside the span
    ``probe/window``, whose ends on the trace's clock bound the stretch,
    recording shapes as the benchmark's traced stretch does."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    harness.synchronize(dev)
    with profile(activities=acts, record_shapes=True) as prof:
        with profiler.span(WINDOW):
            run_units()
            harness.synchronize(dev)
    return reduce(prof, units)


def serve_cell(name, seed, seconds, repeats, dev) -> dict:
    w = harness.load("workloads", name)
    cfg, p = harness.load("configs", w["config"]), w["params"]
    from segmif_tpu_torch.serving import make_serving_fn

    b, h, wd = p["batch"], cfg["height"], cfg["width"]
    dtype = DTYPES[cfg["serve_dtype"]]
    model = build_model(cfg, state.make_state(cfg, seed, dev, dtype), dev,
                        dtype)
    serve = make_serving_fn(model, device=dev)
    pool = state.serve_pool(seed, p["pool"], b, h, wd, dev)
    slots = [serve_closed.Slot(b, h, wd, dev)
             for _ in range(p["in_flight"] + 1)]
    for i in range(p["warmup_batches"]):
        serve(**pool[i % len(pool)])
    harness.synchronize(dev)
    keep = serve_closed.Reservoir(0, np.random.default_rng(0))
    out = {"cell": name, "off_ms": [], "on_ms": [], "spans_ms": [],
           "traced": []}
    for _ in range(repeats):
        for on in (False, True):
            before = profiler.span_totals()
            ctx = profiler.spans_on() if on else _nothing()
            with ctx:
                st = serve_closed.serve_window(serve, pool, slots, seconds,
                                               p["in_flight"], keep, dev)
            out["on_ms" if on else "off_ms"].append(
                statistics.fmean(st["dispatch_ms"]))
            if on:
                out["spans_ms"].append(_spans_ms(
                    before, profiler.span_totals(), st["dispatched"]))
        units = p["trace_batches"]

        def run_units():
            inflight = collections.deque()
            for k in range(units):
                if len(inflight) == p["in_flight"]:
                    inflight.popleft().event.synchronize()
                f, c = serve(**pool[k % len(pool)])
                slot = slots[k % len(slots)]
                slot.fused.copy_(f, non_blocking=True)
                slot.pred.copy_(c, non_blocking=True)
                slot.event.record()
                inflight.append(slot)

        out["traced"].append(_profiled(run_units, units, dev))
    return out


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def train_cell(name, seed, seconds, repeats, dev) -> dict:
    w = harness.load("workloads", name)
    cfg, p = harness.load("configs", w["config"]), w["params"]
    step, st, batches, _, _ = train_fusion.setup(cfg, p, seed, dev)
    for i in range(p["warmup_steps"]):
        step(st, batches[i % len(batches)], p["fusion_scale"])
    harness.synchronize(dev)
    out = {"cell": name, "off_ms": [], "on_ms": [], "spans_ms": [],
           "allocator_calls": [], "traced": []}

    def allocs():
        m = torch.cuda.memory_stats(dev) if dev.type == "cuda" else {}
        return m.get("num_device_alloc", 0) + m.get("num_device_free", 0)

    for _ in range(repeats):
        for on in (False, True):
            before, a0 = profiler.span_totals(), allocs()
            ctx = profiler.spans_on() if on else _nothing()
            with ctx:
                win = train_fusion.train_window(step, st, batches, p,
                                                seconds, dev)
            out["on_ms" if on else "off_ms"].append(
                statistics.fmean(win["dispatch_ms"]))
            out["allocator_calls"].append((allocs() - a0) / win["steps"])
            if on:
                out["spans_ms"].append(_spans_ms(
                    before, profiler.span_totals(), win["steps"]))
        units = p["trace_steps"]

        def run_units():
            for k in range(units):
                step(st, batches[k % len(batches)], p["fusion_scale"])

        out["traced"].append(_profiled(run_units, units, dev))
    out["drained_ms"] = drained(step, st, batches, p, repeats, dev)
    return out


def drained(step, st, batches, p, repeats, dev) -> dict:
    """Each span's host ms in a step that starts on an idle device (a
    synchronise before it), so that no launch waits for room in the
    device's queue; and the synchronising calls a step makes
    (``torch.cuda.set_sync_debug_mode``)."""
    import warnings

    before = profiler.span_totals()
    with profiler.spans_on():
        for k in range(repeats):
            harness.synchronize(dev)
            step(st, batches[k % len(batches)], p["fusion_scale"])
    out = _spans_ms(before, profiler.span_totals(), repeats)
    harness.synchronize(dev)
    if dev.type != "cuda":
        return out
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(st, batches[0], p["fusion_scale"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["sync_calls"] = sum("synchroniz" in str(w.message) for w in seen)
    harness.synchronize(dev)
    out["optimizer_alone_ms"] = optimizer_alone(st, p, repeats, dev)
    out["sync_at"] = sync_site(step, st, batches[0], p, dev)
    return out


def optimizer_alone(st, p, repeats, dev) -> float:
    """Host ms of one AdamW update of the step's leaves (copies, so the
    state is left as it was) dispatched onto an idle device."""
    from segmif_tpu_torch.train.optimizer import adamw_poly

    tx = adamw_poly(p["lr"], 0, p["max_iters"], p["weight_decay"],
                    tuple(p["betas"]), p["warmup_ratio"], 1.0)
    params = {n: t.detach().clone() for n, t in st.params.items()}
    grads = {n: torch.ones_like(t) for n, t in params.items()}
    opt = tx.init(params)
    times = []
    for _ in range(repeats + 1):
        harness.synchronize(dev)
        t = time.perf_counter()
        opt = tx.update(grads, opt, params)
        times.append((time.perf_counter() - t) * 1e3)
    harness.synchronize(dev)
    return statistics.fmean(times[1:])


def sync_site(step, st, batch, p, dev) -> list:
    """Where a step first waits for the device: the port's frames of the
    error ``torch.cuda.set_sync_debug_mode("error")`` raises there (the
    step is cut short: run it last)."""
    import traceback

    harness.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(st, batch, p["fusion_scale"])
    except RuntimeError as e:
        return [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                for f in traceback.extract_tb(e.__traceback__)][-6:]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        harness.synchronize(dev)
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="*", default=[
        "b3_vga_serve_b8", "b5_1080p_serve_b2", "b3_vga_train_fusion_b8"])
    ap.add_argument("--seed", type=int, default=2_718_281_828)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "artifacts" /
                                         "torch_spans.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_spans: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    harness.set_cache_dirs()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    lines = [{"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "costs": costs(dev)}]
    print(json.dumps(lines[0]), flush=True)
    for name in args.cells:
        kind = harness.load("workloads", name)["driver"]
        run = serve_cell if kind == "serve_closed" else train_cell
        lines.append(run(name, args.seed, args.seconds, args.repeats, dev))
        print(json.dumps(lines[-1]), flush=True)
        harness.free_memory(dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
