"""Traffic ``serve_closed``: one client serving pairs through the port's
serving closure in a closed loop.

The client keeps ``in_flight`` batches of ``batch`` IR/VIS pairs in
flight: it enqueues a batch through the closure of
``segmif_tpu_torch.serving.make_serving_fn`` (default mode: the guide is
the VIS frame, re-encoded), enqueues the copy of its fused RGB image and
class map into pinned host memory, and waits for the oldest batch's copy
before it enqueues another. The inputs are a pool of ``pool`` distinct
batches made on the device from the seed, sent in turn.

End to end (host clock): ``serve_pairs_per_s``, the pairs whose outputs
reached host memory inside the window over its seconds;
``serve_batch_p95_ms``, the 95th percentile over every batch of the
window of the time from its dispatch to its outputs in host memory;
``peak_mem_gib``; ``setup_s``.

Correctness: a sample of ``sample_batches`` of the batches completed in
the window, drawn from the seed, keeps its outputs (its pinned buffers are
swapped out of the ring, so nothing is copied). After the window the
program is freed and the reference, in float32, serves the same inputs
with the same weights: ``fused_max_abs`` is the largest difference of a
served fused-image value from the reference's, ``fused_mean_abs`` the
mean of those differences, ``seg_logit_gap`` the widest gap by which the
reference's logit of a served class lies below its best logit at that
pixel.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import harness, state, trace
from ..harness import Cell, Outcome
from ..program import DTYPES, build_model, layers
from ..reference.model import Reference, widest_gap
from ..reference.precision import strict_float32
from ..yardstick.flops import serve_flops_per_pair


class Slot:
    """Pinned host buffers for one batch's outputs, and the event that
    says its copies are done."""

    def __init__(self, b: int, h: int, w: int, device):
        pin = device.type == "cuda"
        self.fused = torch.empty((b, h, w, 3), dtype=torch.float32,
                                 pin_memory=pin)
        self.pred = torch.empty((b, h, w), dtype=torch.int32,
                                pin_memory=pin)
        self.event = harness.event(device)


class Reservoir:
    """A uniform sample of ``size`` of the batches offered, drawn from
    ``rng`` (algorithm R). It keeps a batch by keeping its slot; ``offer``
    returns the slot that goes back to the ring, if any."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng = size, rng
        self.kept: List[tuple] = []
        self.seen = 0

    def offer(self, index: int, slot: Slot) -> Optional[Slot]:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((index, slot))
            return None
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            old = self.kept[j][1]
            self.kept[j] = (index, slot)
            return old
        return slot


def faulty(serve, fault: Optional[str], classes: int):
    """The closure with a planted fault (the harness's tests and the
    limits' readings): ``answer``, a 16 x 16 block of the first pair's
    class map moved to the next class and of its fused image moved by
    0.25, where they are produced; ``half_batch``, the second half of each
    batch answered with the first half's outputs."""
    if fault is None:
        return serve

    def wrapped(ir, vis):
        fused, pred = serve(ir, vis)
        fused, pred = fused.clone(), pred.clone()
        if fault == "answer":
            pred[0, :16, :16] = (pred[0, :16, :16] + 1) % classes
            f = fused[0, :16, :16]
            fused[0, :16, :16] = torch.where(f > 0.5, f - 0.25, f + 0.25)
        elif fault == "half_batch":
            h = fused.shape[0] // 2
            fused[h:2 * h] = fused[:h]
            pred[h:2 * h] = pred[:h]
        else:
            raise ValueError(f"unknown fault {fault!r}")
        return fused, pred

    return wrapped


def serve_window(serve, pool, slots, seconds: float, in_flight: int,
                 keep: Reservoir, device, stretch: Optional[Dict] = None,
                 marked=None) -> Dict:
    """The closed loop for ``seconds``. ``stretch``: {"units", "at"}:
    profile ``units`` batches starting at ``at`` of the window, with the
    ``marked`` layers' ranges."""
    clock = time.perf_counter
    free = list(slots)
    inflight: collections.deque = collections.deque()
    st = {"lat_ms": [], "dispatch_ms": [], "completed": 0, "late": 0,
          "dispatched": 0, "stretch_completed": 0, "trace": None,
          "stretch_s": 0.0, "units": 0}
    phase = "before" if stretch else "none"
    prof = ranges = None
    t_start = clock()
    end = t_start + seconds
    k = k_s = 0
    t_s0 = 0.0

    def complete_oldest():
        k_i, t_d, slot, in_stretch = inflight.popleft()
        slot.event.synchronize()
        t_done = clock()
        back = slot
        if t_done <= end:
            st["completed"] += 1
            st["stretch_completed"] += in_stretch
            st["lat_ms"].append((t_done - t_d) * 1e3)
            back = keep.offer(k_i, slot)
        else:
            st["late"] += 1
        if back is not None:
            free.append(back)

    while True:
        now = clock()
        if phase == "before" and now >= t_start + stretch["at"] * seconds:
            while inflight:
                complete_oldest()
            harness.synchronize(device)
            ranges = trace.ranges(marked)
            ranges.__enter__()
            prof = trace.Profile(device)
            prof.start()
            t_s0, k_s, phase = clock(), k, "in"
            continue
        if (now < end and len(inflight) < in_flight
                and not (phase == "in" and k - k_s >= stretch["units"])):
            batch = pool[k % len(pool)]
            t_d = clock()
            if phase == "in":
                with trace.span("dispatch"):
                    fused, pred = serve(batch["ir"], batch["vis"])
            else:
                fused, pred = serve(batch["ir"], batch["vis"])
            if phase != "in":
                st["dispatch_ms"].append((clock() - t_d) * 1e3)
            slot = free.pop()
            slot.fused.copy_(fused, non_blocking=True)
            slot.pred.copy_(pred, non_blocking=True)
            slot.event.record()
            inflight.append((k, t_d, slot, phase == "in"))
            k += 1
            continue
        if inflight:
            complete_oldest()
            continue
        if phase == "in":
            harness.synchronize(device)
            st["stretch_s"] = clock() - t_s0
            prof.stop()
            ranges.__exit__(None, None, None)
            st["trace"] = prof
            st["units"] = k - k_s
            phase = "after"
            continue
        break
    st["dispatched"] = k
    st["seconds"] = seconds
    if st["trace"] is not None:      # read after the window
        st["trace"] = st["trace"].result()
    return st


def reference_checks(cfg: Dict, seed: int, params: Dict,
                     sides: Dict[str, list], device,
                     controls: Optional[Dict[str, str]] = None
                     ) -> Dict[str, Dict]:
    """The compared numbers of each side's kept batches against the
    reference in float32, in one reference pass: ``sides`` maps a side
    (``program``, a planted fault, a control) to its kept (index, slot)
    pairs, the pool batch index and the slot holding its served outputs.
    ``controls``: {side: precision}, the reference put in the program's
    place in that precision, serving the same pool batches."""
    b, h, w = params["batch"], cfg["height"], cfg["width"]
    controls = controls or {}
    acc = {s: {"max": 0.0, "gap": 0.0, "sum": 0.0, "count": 0}
           for s in list(sides) + list(controls)}
    with strict_float32(), torch.no_grad():
        sd = {k: v.float() for k, v in state.make_state(
            cfg, seed, device, DTYPES[cfg["serve_dtype"]]).items()}
        ref = Reference(cfg, sd)
        lows = {s: Reference(cfg, sd, prec) for s, prec in controls.items()}
        pool = state.serve_pool(seed, params["pool"], b, h, w, device)
        served = collections.defaultdict(list)
        for side, kept in sides.items():
            for index, slot in kept:
                served[index % len(pool)].append((side, slot.fused,
                                                  slot.pred))
        for j in sorted(served):
            inputs = pool[j]
            for i in range(b):
                ir, vis = inputs["ir"][i:i + 1], inputs["vis"][i:i + 1]
                fused, logits = ref.serve(ir, vis)
                got = [(s, f[i:i + 1].to(device), c[i:i + 1].to(device))
                       for s, f, c in served[j]]
                for side, low in lows.items():
                    lf, ll = low.serve(ir, vis)
                    got.append((side, lf, ll.argmax(-1)))
                for side, f, c in got:
                    a, diff = acc[side], (f - fused).abs()
                    a["max"] = max(a["max"], float(diff.max()))
                    a["sum"] += float(diff.sum())
                    a["count"] += diff.numel()
                    a["gap"] = max(a["gap"], widest_gap(logits, c))
        del sd, ref, lows, pool
    return {s: {"fused_mean_abs": a["sum"] / max(a["count"], 1),
                "fused_max_abs": a["max"], "seg_logit_gap": a["gap"]}
            for s, a in acc.items()}


CHECK_WHAT = {
    "fused_mean_abs": "mean |served fused RGB - reference| over the "
                      "sampled batches",
    "fused_max_abs": "largest |served fused RGB - reference| over the "
                     "sampled batches",
    "seg_logit_gap": "widest gap of a served class's reference logit "
                     "below the reference's best",
}


def checks_of(numbers: Dict[str, float], limits: Dict) -> List[Dict]:
    """The numbers the cell's limits name, each beside its limit."""
    return [{"name": n, "value": numbers.get(n), "limit": limits[n],
             "what": CHECK_WHAT[n]} for n in limits]


def run(cell: Cell) -> Outcome:
    cfg, p, dev = cell.config, cell.params, cell.device
    from segmif_tpu_torch.serving import make_serving_fn

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    b, h, w = p["batch"], cfg["height"], cfg["width"]
    dtype = DTYPES[cfg["serve_dtype"]]
    model = build_model(cfg, state.make_state(cfg, cell.seed, dev, dtype),
                        dev, dtype)
    serve = faulty(make_serving_fn(model, device=dev), cell.fault,
                   cfg["num_classes"])
    pool = state.serve_pool(cell.seed, p["pool"], b, h, w, dev)
    slots = [Slot(b, h, w, dev) for _ in range(p["in_flight"]
                                               + p["sample_batches"] + 1)]
    # set-up: the window's one shape, its calls and copies
    for i in range(p["warmup_batches"]):
        f, c = serve(**pool[i % len(pool)])
        slots[i % 2].fused.copy_(f, non_blocking=True)
        slots[i % 2].pred.copy_(c, non_blocking=True)
    harness.synchronize(dev)
    if cell.trace and dev.type == "cuda":
        trace.Profile.warm_up()
    keep = Reservoir(p["sample_batches"], np.random.default_rng(
        state.sub_seed(cell.seed, state.SAMPLE)))
    setup_s = time.time() - cell.t0_wall
    st = serve_window(serve, pool, slots, cell.seconds, p["in_flight"],
                      keep, dev, {"units": p["trace_batches"], "at": 0.25}
                      if cell.trace else None, layers(model))
    peak = harness.memory_peak(dev)
    del serve, model, pool
    harness.free_memory(dev)
    numbers = reference_checks(cfg, cell.seed, p, {"program": keep.kept},
                               dev)["program"]
    lat = st["lat_ms"]
    e2e = {"serve_pairs_per_s": (st["completed"] * b / cell.seconds,
                                 "pairs/s"),
           "serve_batch_p95_ms": (float(np.percentile(lat, 95))
                                  if lat else float("nan"), "ms"),
           "peak_mem_gib": (peak / harness.GIB, "GiB"),
           "setup_s": (setup_s, "s")}
    run_ = None
    if cell.trace and st["trace"] is not None:
        run_ = trace.TracedRun(
            "serve", [st["trace"]], st["units"], b,
            serve_flops_per_pair(cfg), 1, st["dispatch_ms"],
            (st["completed"] - st["stretch_completed"]) * b,
            cell.seconds - st["stretch_s"])
    return Outcome(e2e, st["dispatched"] * b,
                   (st["dispatched"] - st["completed"] - st["late"]) * b,
                   peak, checks_of(numbers, cell.limits), run_)
