"""Traffic ``train_fusion``: fusion-phase training steps of rounds >= 2
through the port's step, ``segmif_tpu_torch.train.steps.
make_fusion_train_step`` (MSE + SSIM, and cross-entropy through the frozen
seg network, combined by DWA; one AdamW update of the fusion network; bf16
compute on f32 master weights).

Set-up builds the step and its state once, from the seed, and drives that
same object through its first ``check_steps`` steps on distinct batches of
a pool made on the device (the window's own call and feed); they are the
steps the check compares. The window then runs steps on the pool's
batches in turn, at most two in flight, for ``--seconds``, and ends in a
synchronise.

End to end (host clock): ``train_pairs_per_s``, the pairs of the steps
completed over the window's seconds (dispatch to the last synchronise);
``peak_mem_gib``; ``setup_s``.

Correctness against the reference (float32, the same weights and
batches, after the window, the program freed): ``loss_fusion_rel_gap_first``,
the relative gap of the first step's fusion loss (MSE + SSIM);
``grad_norm_gap``, the first gradient as the optimizer got it (its first
moment over 1 - beta1), by the worst weight of the fusion net's tail
(``conv2``, ``conv21``, ``conv22``): the gap between the program's norm and
the reference's, over the larger of the reference's norm of that leaf and
of the median leaf; ``update_norm_gap``, the same of each tail weight's
change in the first step; ``update_norm_gap_all_median``, the median over
every leaf of that change's gap, which covers the leaves whose gradient
comes back through the DRDBs' and the FFM's backward (a backward that
returns zeros leaves more than half the leaves unmoved, at a gap of about
1). Leaves whose reference gradient is under a thousandth of the median
leaf's are left out. Read beside them and not compared (PERF.md, section
2, gives the readings and the cause): every step's losses, the changes
over all the compared steps, the worst leaf's gaps. Every leaf before the
tail takes its gradient through the FFM's context softmax, whose logits
sum over every pixel and sit near ties, so any rounding moves single
leaves' gradients by up to a hundred times their norm, the reference's
own maths held in bfloat16 as much as the program; and from the second
step on, rounding alone parts the trajectories (the third step's loss by
up to 14 % between the float32 and the bfloat16 maths on one seed).
"""
from __future__ import annotations

import collections
import statistics
import time
from typing import Dict, List, Optional

import torch

from .. import harness, state, trace
from ..harness import Cell, Outcome
from ..program import DTYPES, build_model
from ..reference.precision import strict_float32
from ..reference.train import reference_readings
from ..yardstick.flops import train_flops_per_pair

TINY_LEAF = 1e-3
# the fusion net's tail: the weights whose gradient the FFM's context
# softmax does not reach (their biases are one to 64 numbers, whose AdamW
# change over three steps halves when one step's sign flips)
TAIL = ("conv2.weight", "conv21.weight", "conv22.weight")


def hyper(p: Dict) -> Dict:
    """The step's hyperparameters as the reference takes them."""
    return {k: p[k] for k in (
        "lr", "max_iters", "weight_decay", "eps", "fusion_scale",
        "seg_scale", "dwa_temperature", "dwa_warmup", "ignore_index",
        "ssim_weight")} | {"betas": tuple(p["betas"])}


def make_step(cfg: Dict, p: Dict, model, device):
    """The port's fusion step and its state (the trainer's optimizer,
    ``adamw_poly``, at the traffic's learning rate, no warm-up)."""
    from segmif_tpu_torch.train.optimizer import adamw_poly
    from segmif_tpu_torch.train.state import FusionTrainState
    from segmif_tpu_torch.train.steps import make_fusion_train_step

    tx = adamw_poly(p["lr"], 0, p["max_iters"], p["weight_decay"],
                    tuple(p["betas"]), p["warmup_ratio"], 1.0)
    if p["eps"] != tx.eps:
        raise ValueError(f"the traffic's AdamW eps {p['eps']} is not the "
                         f"port's {tx.eps}")
    step = make_fusion_train_step(
        model, tx, round1=False, ignore_index=p["ignore_index"],
        seg_scale=p["seg_scale"], dwa_temperature=p["dwa_temperature"],
        dwa_warmup_steps=p["dwa_warmup"],
        compute_dtype=DTYPES[cfg["train_compute_dtype"]], device=device)
    return step, FusionTrainState.create(model.fusion, tx)


# the fusion network's calls whose backward a planted fault zeroes, by
# the name it calls them under in ``segmif_tpu_torch.models.fusion``
GRAD_ZEROED = {"drdb_grad_zeroed": "drdb_block",
               "ffm_grad_zeroed": "crosspath_apply"}


def _tensors(x) -> List[torch.Tensor]:
    """The tensors in ``x``, through lists, tuples and dicts' values."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    return []


def _grad_zeroed(fn):
    """``fn`` with a backward that returns zeros: the same outputs, and a
    gradient of 0 for every tensor it takes, as an ``autograd.Function``
    whose backward left its work out."""
    def wrapped(*args):
        out = fn(*args)
        ins = [t for t in _tensors(args) if t.requires_grad]
        if not ins:
            return out
        zero = sum(t.sum() * 0.0 for t in ins)
        if isinstance(out, tuple):
            return tuple(o.detach() + zero.to(o.dtype) for o in out)
        return out.detach() + zero.to(out.dtype)

    return wrapped


def faulty(step, fault: Optional[str]):
    """The step with a planted fault (the harness's tests and the limits'
    readings): ``unchanged``, a step that returns its state as it found
    it; ``half_batch``, half of the batch left out, the means taken over
    the rest; ``drdb_grad_zeroed`` and ``ffm_grad_zeroed``, the DRDBs' or
    the FFM's backward returning zeros."""
    if fault is None or fault == "no_exchange":
        return step

    def wrapped(st, batch, fusion_scale, shard=None):
        if fault == "half_batch":
            h = batch["ir"].shape[0] // 2
            return step(st, {k: v[:h] for k, v in batch.items()},
                        fusion_scale, shard)
        if fault in GRAD_ZEROED:
            import segmif_tpu_torch.models.fusion as fusion

            name = GRAD_ZEROED[fault]
            plain = getattr(fusion, name)
            setattr(fusion, name, _grad_zeroed(plain))
            try:
                return step(st, batch, fusion_scale, shard)
            finally:
                setattr(fusion, name, plain)
        if fault != "unchanged":
            raise ValueError(f"unknown fault {fault!r}")
        with torch.no_grad():
            keep = [t.clone() for t in _state_tensors(st)]
        dwa, count = st.dwa, st.step
        out = step(st, batch, fusion_scale, shard)
        with torch.no_grad():
            for t, k in zip(_state_tensors(st), keep):
                t.copy_(k)
        st.dwa, st.step = dwa, count
        return out

    wrapped.seg = step.seg
    return wrapped


def _state_tensors(st) -> List[torch.Tensor]:
    o = st.opt_state
    return (list(st.params.values()) + list(o.mu.values())
            + list(o.nu.values()) + [o.count])


def first_steps(step, st, batches, p: Dict, shard=None) -> Dict:
    """Drive the step through the compared steps; the readings, on the
    host: each step's total loss, the first gradient's norm per leaf
    (the optimizer's first moment after one step over 1 - beta1), each
    leaf's change over the steps."""
    start = {n: t.detach().clone() for n, t in st.params.items()}
    losses, fusion_losses, grads, first = [], [], None, None
    for i, batch in enumerate(batches):
        m = step(st, batch, p["fusion_scale"], shard)
        losses.append(m["loss"])
        fusion_losses.append(m["loss_fusion"])
        if i == 0:
            b1 = p["betas"][0]
            grads = {n: (mu / (1 - b1)).double().norm()
                     for n, mu in st.opt_state.mu.items()}
            first = {n: (st.params[n] - start[n]).double().norm()
                     for n in start}
    change = {n: (st.params[n] - start[n]).double().norm() for n in start}
    host = lambda d: dict(zip(d, torch.stack(list(d.values())).tolist()))  # noqa: E731
    return {"losses": torch.stack(losses).tolist(),
            "fusion_losses": torch.stack(fusion_losses).tolist(),
            "grad_norms": host(grads), "change_norms": host(change),
            "first_change_norms": host(first)}


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              keep) -> List[float]:
    """Each kept leaf's |program norm - reference norm| over the larger of
    the reference's norm of the leaf and of the median leaf."""
    med = statistics.median(ref[n] for n in keep)
    return [abs(got[n] - ref[n]) / max(ref[n], med) for n in keep]


def compare(got: Dict, ref: Dict) -> Dict[str, float]:
    """One side's numbers against the reference's readings: the steps'
    losses, the gradient and change of the tail's leaves (``TAIL``), and
    the same over every leaf (worst and median), each leaf's gap over the
    larger of its reference norm and the median leaf's. A cell's limits
    name the ones compared (PERF.md, section 2, says why the others are
    not)."""
    med = statistics.median(ref["grad_norms"].values())
    keep = [n for n, v in ref["grad_norms"].items() if v >= TINY_LEAF * med]
    tail = [n for n in keep if n in TAIL]
    out = {}
    for name, key in (("loss_rel_gap", "losses"),
                      ("loss_fusion_rel_gap", "fusion_losses")):
        gaps = [abs(a - b) / abs(b) for a, b in zip(got[key], ref[key])]
        out[name], out[name + "_first"] = max(gaps), gaps[0]
    for name, key in (("grad_norm_gap", "grad_norms"),
                      ("update_norm_gap", "first_change_norms"),
                      ("update_norm_gap_steps", "change_norms")):
        gaps = dict(zip(keep, leaf_gaps(got[key], ref[key], keep)))
        out[name] = max(gaps[n] for n in tail)
        out[name + "_all_worst"] = max(gaps.values())
        out[name + "_all_median"] = statistics.median(gaps.values())
    return out


CHECK_WHAT = {
    "loss_rel_gap": "largest relative gap of a compared step's total loss",
    "loss_fusion_rel_gap": "largest relative gap of a compared step's "
                           "fusion loss (MSE + SSIM)",
    "loss_rel_gap_first": "relative gap of the first step's total loss",
    "loss_fusion_rel_gap_first": "relative gap of the first step's fusion "
                                 "loss",
    "grad_norm_gap": "worst tail weight's gap of the first gradient's "
                     "norm, over max(its reference norm, the median "
                     "leaf's)",
    "update_norm_gap": "worst tail weight's gap of the norm of its change "
                       "in the first step, over max(its, the median leaf's)",
    "update_norm_gap_all_median": "median over every leaf of its gap of "
                                  "the norm of its change in the first "
                                  "step, over max(its, the median leaf's)",
}


def checks_of(numbers: Dict[str, float], limits: Dict) -> List[Dict]:
    """The numbers the cell's limits name, each beside its limit."""
    return [{"name": n, "value": numbers.get(n), "limit": limits[n],
             "what": CHECK_WHAT[n]} for n in limits]


def reference(cfg: Dict, p: Dict, seed: int, device,
              precision: str = "float32") -> Dict:
    """The reference's readings of the compared steps, from the seed."""
    with strict_float32():
        sd = state.make_state(cfg, seed, device, torch.float32)
        pool = state.train_pool(seed, p["pool"], p["global_batch"],
                                cfg["height"], cfg["width"],
                                cfg["num_classes"], p["ignore_share"],
                                p["ignore_index"], p["ramp_rows"], device)
        out = reference_readings(cfg, sd, hyper(p),
                                 pool[:p["check_steps"]], precision,
                                 p["micro_batch"])
        del sd, pool
    return out


def train_window(step, st, batches, p: Dict, seconds: float, device,
                 shard=None, stretch: Optional[Dict] = None, marked=None,
                 count: Optional[int] = None) -> Dict:
    """Steps on ``batches`` in turn, at most two in flight, for
    ``seconds`` (or ``count`` steps), then a synchronise. ``stretch``:
    {"units", "at"}: profile ``units`` steps from ``at`` of the window."""
    clock = time.perf_counter
    events: collections.deque = collections.deque()
    st_ = {"dispatch_ms": [], "losses": [], "trace": None, "units": 0,
           "stretch_s": 0.0}
    t_start = clock()
    end = t_start + seconds
    k = 0
    at = None if stretch is None else (
        stretch["at"] * (seconds if count is None else count))
    while (clock() < end) if count is None else (k < count):
        batch = batches[k % len(batches)]
        due = clock() - t_start if count is None else k
        if at is not None and due >= at and st_["trace"] is None:
            harness.synchronize(device)
            events.clear()
            t_s0 = clock()
            with trace.ranges(marked):
                prof = trace.Profile(device)
                prof.start()
                for _ in range(stretch["units"]):
                    with trace.span("step"):
                        m = step(st, batches[k % len(batches)],
                                 p["fusion_scale"], shard)
                    st_["losses"].append(m["loss"])
                    k += 1
                harness.synchronize(device)
                st_["stretch_s"] = clock() - t_s0
                prof.stop()
            st_["trace"] = prof
            st_["units"] = stretch["units"]
            continue
        t_d = clock()
        m = step(st, batch, p["fusion_scale"], shard)
        st_["dispatch_ms"].append((clock() - t_d) * 1e3)
        st_["losses"].append(m["loss"])
        ev = harness.event(device)
        ev.record()
        events.append(ev)
        if len(events) > 2:
            events.popleft().synchronize()
        k += 1
    harness.synchronize(device)
    st_["seconds"] = clock() - t_start
    st_["steps"] = k
    if st_["trace"] is not None:     # read after the window
        st_["trace"] = st_["trace"].result()
    losses = torch.stack(st_.pop("losses")) if k else torch.zeros(0)
    st_["failed"] = int((~torch.isfinite(losses)).sum()) if k else 0
    return st_


def setup(cfg: Dict, p: Dict, seed: int, device, rows=lambda b: b,
          shard=None, fault: Optional[str] = None, replicate=None):
    """The step, its state and the batch pool (this rank's rows); then the
    compared steps, driven through the step itself. ``replicate``: what
    the trainer does to the model under data parallelism. Returns (step,
    state, batches, readings, marked layers)."""
    master = DTYPES[cfg["train_master_dtype"]]
    model = build_model(cfg, state.make_state(cfg, seed, device, master),
                        device, master)
    if replicate is not None:
        replicate(model)
    step, st = make_step(cfg, p, model, device)
    step = faulty(step, fault)
    pool = state.train_pool(seed, p["pool"], p["global_batch"],
                            cfg["height"], cfg["width"], cfg["num_classes"],
                            p["ignore_share"], p["ignore_index"],
                            p["ramp_rows"], device)
    batches = [rows(b) for b in pool]
    del pool
    readings = first_steps(step, st, batches[:p["check_steps"]], p, shard)
    marked = {"fusion": [model.fusion],
              "mit": [step.seg.denoise_net.encoder,
                      step.seg.denoise_net.decoder]}
    return step, st, batches, readings, marked


def run(cell: Cell) -> Outcome:
    cfg, p, dev = cell.config, cell.params, cell.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    step, st, batches, readings, marked = setup(
        cfg, p, cell.seed, dev, fault=cell.fault)
    for i in range(p["warmup_steps"]):
        step(st, batches[(p["check_steps"] + i) % len(batches)],
             p["fusion_scale"])
    harness.synchronize(dev)
    if cell.trace and dev.type == "cuda":
        trace.Profile.warm_up()
    setup_s = time.time() - cell.t0_wall
    w = train_window(step, st, batches, p, cell.seconds, dev,
                     stretch={"units": p["trace_steps"], "at": 0.25}
                     if cell.trace else None, marked=marked)
    peak = harness.memory_peak(dev)
    del step, st, batches, marked
    harness.free_memory(dev)
    numbers = compare(readings, reference(cfg, p, cell.seed, dev))
    b = p["global_batch"]
    e2e = {"train_pairs_per_s": (w["steps"] * b / w["seconds"], "pairs/s"),
           "peak_mem_gib": (peak / harness.GIB, "GiB"),
           "setup_s": (setup_s, "s")}
    run_ = None
    if cell.trace and w["trace"] is not None:
        run_ = trace.TracedRun(
            "train", [w["trace"]], w["units"], b, train_flops_per_pair(cfg),
            1, w["dispatch_ms"], (w["steps"] - w["units"]) * b,
            w["seconds"] - w["stretch_s"])
    return Outcome(e2e, w["steps"] * b, w["failed"] * b, peak,
                   checks_of(numbers, cell.limits), run_)
