"""Traffic ``train_seg``: seg-phase training steps through the port's step,
``segmif_tpu_torch.train.steps.make_seg_train_step``, with the seg
phase's optimizer, ``train.optimizer.adamw_poly_grouped``, as
``InteractiveTrainer`` builds them: RGB crops and labels -> the
segmentation network in training mode (drop-path, BatchNorm on the
batch's statistics, dropout) -> cross-entropy with the ignore label ->
one AdamW update of every weight over three groups (the decoder at 10 x
the learning rate); bf16 compute on f32 master weights. The joint
pipeline is built whole (``program.build_model``); its seg network is
trained, its fusion net is not run.

Set-up builds the step and its state from the seed and drives that same
object through its first ``check_steps`` steps on distinct batches of a
pool of RGB crops in [0, 1) and labels (uniform over the classes,
``ignore_share`` of the pixels set to the ignore index), made on the
device. Every step draws its drop-path and dropout masks from the step's
own generator; in the compared steps the driver records them (it wraps
the port's ``mit.drop_path_mask`` and ``segformer_head.dropout_mask``),
and the reference applies the same masks. The window then runs steps on
the pool's batches in turn, at most two in flight, for ``--seconds``
(``train_fusion.train_window``), and ends in a synchronise.

End to end (host clock): ``train_pairs_per_s``, the crops (with their
labels) of the steps completed over the window's seconds;
``peak_mem_gib``; ``setup_s``.

Traced: as ``train_fusion``'s, with a ``pb:seg_head`` range around the
head's forward (``seg_head_device_ms.train``), the model FLOPs of a pair
3 x ``seg_flops`` (forward and backward of every weight), and, for the
window's steps outside the profiled stretch, the port's host accounting
of its spans (``utils.profiler.spans_on``): the totals of the window's
span calls, {name: (host ns, calls)}, as the run's ``span_totals``
(``backward_host_ms.train``, ``optimizer_host_ms.train``; empty on a
program without the step's spans).

Correctness against the reference (``reference/seg_train.py``, float32,
TF32 off, the same weights, batches and masks, after the window, the
program freed). The numbers, and why each limit lies where it does
(PERF.md, section 2, gives the readings):

 - ``loss_rel_gap_first``: the relative gap of the first step's loss,
   computed on the same weights. The program's bf16 products move it by
   a few 1e-4; the head's BatchNorm on running statistics and the float8
   control move it by more;
 - ``head_grad_rel_err``: the first gradient as the optimizer got it (its
   first moment over 1 - beta1) of the head's ``linear_fuse.conv`` and
   ``linear_pred`` weights, the worse of ||program - reference|| over
   ||reference||. These weights take their gradient from the loss
   through the head alone, so their error is the bf16 head's, and half a
   batch's gradient is another;
 - ``grad_rel_err_family_worst``: the worst family of leaves (those that
   differ only in their block's index within a stage:
   ``block3.*.mlp.dwconv.dwconv.weight`` holds stage 3's 40 depthwise
   conv weights; a leaf outside the blocks is a family of its own) by
   the same error over the family's leaves taken together. A family
   whose gradient is lost reads 1 at any scale, so that no family (the
   depthwise conv's, q's, a norm's) hides under the others, as about a
   tenth of the leaves could under a percentile; the rounding of bf16
   through 52 blocks keeps the sound worst far below. An sr-attention
   backward that returns zeros loses q, kv, sr and norm1's, a zeroed
   depthwise conv weight gradient its own family;
 - ``grad_rel_err_all_worst``: the worst leaf of the same error over the
   larger of the leaf's reference norm and the median leaf's: one leaf
   wrong inside its family;
 - ``update_norm_gap_all_median``: the median over every leaf of the gap
   of the norm of its change in the first step, over the larger of its
   and the median leaf's: about 1 for a step that leaves the weights as
   they were;
 - ``bn_running_mean_gap``: the head BatchNorm's running mean after the
   first step, ||program - reference|| over the reference's change from
   its start: a BatchNorm that does not fold the batch's statistics
   reads 1. (After the later steps the two trajectories have parted:
   AdamW's first updates are near lr times a gradient's sign, so a
   rounding that flips a ReLU in the head moves weights by whole steps.)
 - ``mask_keep_z``: the masks the reference takes from the program,
   held to the reference's own schedule (``seg_train.keep_probabilities``):
   the compared steps' kept draws, drop-path's pooled over every block
   and sample (2,448 draws at batch 8, 124.8 drops expected, 10.8 their
   deviation) and dropout's over every element (1.2e9), each as |z|, the
   larger. Masks drawn at another rate or keeping all read far above
   (keeping all: drop-path 11.6, dropout 11,585); sound draws pass 5
   but for about 1 run in 500,000 (the exact tails, 1.3e-6 and 5.7e-7).

Each limit but ``mask_keep_z``'s lies between the program's largest
reading (over 42 seeds; the worst family's over 21, the worst leaf's
over 31) and the float8 control's least (a fault's where the control does not
fail the number), with room on both sides: ``loss_rel_gap_first``
0.0015 (0.00049; 0.0086), ``head_grad_rel_err`` 0.06 (0.0170; 0.190),
``grad_rel_err_family_worst`` 0.2 (0.066; 0.762),
``grad_rel_err_all_worst`` 0.25 (0.085; 1.02),
``update_norm_gap_all_median`` 0.05 (0.000055; the unchanged step's
1.0) and ``bn_running_mean_gap`` 0.03 (0.0074; 0.174). The reference
held in bfloat16 reads the program's levels of the gradient numbers
(head 0.0171, family 0.086, leaf 0.108): the program's error is that of
its bf16 products.

Leaves whose reference gradient is under a thousandth of the median
leaf's (the aux classifier, which no loss reaches) are left out of the
leaf-wise numbers. Read beside them and not compared: every step's
loss, the median leaf's error and the 90th percentile's, the changes
over all the compared steps, the running buffers' gaps after them, the
running variance's gap.
"""
from __future__ import annotations

import contextlib
import math
import re
import statistics
import time
from typing import Dict, List, Optional

import torch

from .. import harness, state, trace
from ..harness import Cell, Outcome
from ..program import DTYPES, build_model
from ..reference.precision import strict_float32
from ..reference.seg_train import BN_MOMENTUM, STATS, seg_readings
from ..reference.train import leaf_norms
from ..yardstick.flops import seg_flops
from . import train_fusion

# stream tags of the seed (``state``'s are 1-4)
SEG_INPUTS, DRAWS = 5, 6
TINY_LEAF = 1e-3
# the head's weights whose gradient comes from the loss through the head
HEAD = ("denoise_net.decoder.linear_fuse.conv.weight",
        "denoise_net.decoder.linear_pred.weight")
DWCONV = "mlp.dwconv.dwconv.weight"
FAULTS = ("unchanged", "half_batch", "sr_attention_grad_zeroed",
          "bn_running_stats", "dwconv_grad_zeroed", "masks_all_kept")


def hyper(p: Dict) -> Dict:
    """The step's hyperparameters as the reference takes them."""
    return {k: p[k] for k in (
        "lr", "decoder_lr_mult", "weight_decay", "eps", "power",
        "max_iters", "warmup_iters", "warmup_ratio", "start_step",
        "drop_path", "dropout", "ignore_index")} | {
        "betas": tuple(p["betas"])}


def seg_pool(seed: int, p: Dict, cfg: Dict, device
             ) -> List[Dict[str, torch.Tensor]]:
    """``pool`` distinct batches of RGB crops [B, H, W, 3], uniform in
    [0, 1), float32, and labels [B, H, W] uniform over the classes with
    ``ignore_share`` of the pixels set to ``ignore_index``."""
    g = state.generator(seed, SEG_INPUTS, device)
    n, b, h, w = p["pool"], p["global_batch"], cfg["height"], cfg["width"]
    image = torch.rand((n, b, h, w, 3), generator=g, device=device)
    label = torch.randint(0, cfg["num_classes"], (n, b, h, w), generator=g,
                          device=device)
    drop = torch.rand((n, b, h, w), generator=g,
                      device=device) < p["ignore_share"]
    label = torch.where(drop, torch.full_like(label, p["ignore_index"]),
                        label)
    return [{"image": image[i], "label": label[i]} for i in range(n)]


def make_step(cfg: Dict, p: Dict, model, device):
    """The port's seg step and its state, as the trainer's seg phase
    builds them (``adamw_poly_grouped`` over the seg network's names)."""
    from segmif_tpu_torch.train.optimizer import adamw_poly_grouped
    from segmif_tpu_torch.train.state import SegTrainState
    from segmif_tpu_torch.train.steps import make_seg_train_step

    seg = model.seg
    tx = adamw_poly_grouped(
        [n for n, _ in seg.named_parameters()], p["lr"], p["warmup_iters"],
        p["max_iters"], p["weight_decay"], tuple(p["betas"]),
        p["warmup_ratio"], p["power"], p["start_step"],
        p["decoder_lr_mult"])
    net = seg.denoise_net
    port = {"eps": tx.eps,
            "drop_path": net.encoder.config.drop_path_rate,
            "dropout": net.decoder.dropout_rate}
    for key, value in port.items():
        if p[key] != value:
            raise ValueError(f"the traffic's {key} {p[key]} is not the "
                             f"port's {value}")
    step = make_seg_train_step(seg, tx, p["ignore_index"],
                               DTYPES[cfg["train_compute_dtype"]], device)
    return step, SegTrainState.create(seg, tx)


@contextlib.contextmanager
def recorded_masks():
    """The masks the port's drop-path and dropout draw inside the block,
    in the order drawn: a list of (kind, mask)."""
    import segmif_tpu_torch.models.mit as mit
    import segmif_tpu_torch.models.segformer_head as head

    got: List = []
    plain = {(mit, "drop_path_mask"): mit.drop_path_mask,
             (head, "dropout_mask"): head.dropout_mask}

    def recording(kind, fn):
        def wrapped(*args):
            m = fn(*args)
            got.append((kind, m))
            return m
        return wrapped

    for (mod, name), fn in plain.items():
        setattr(mod, name, recording(name, fn))
    try:
        yield got
    finally:
        for (mod, name), fn in plain.items():
            setattr(mod, name, fn)


def step_masks(got: List) -> Dict:
    """One step's recorded masks on the host, as the reference takes
    them."""
    return {"drop_path": [m.cpu() for k, m in got if k == "drop_path_mask"],
            "dropout": next((m.cpu() for k, m in got
                             if k == "dropout_mask"), None)}


def _bn_on_running_stats(x, bn, shard=None):
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight.float()
    return ((x.float() - bn.running_mean[:, None, None]) * mul[:, None, None]
            + bn.bias.float()[:, None, None]).to(x.dtype)


def faulty(step, fault: Optional[str]):
    """The step with a planted fault (the harness's tests and the limits'
    readings): ``unchanged``, a step that returns its state as it found
    it; ``half_batch``, the second half of the batch's crops and labels
    replaced by the first half's (the means taken over half the images);
    ``sr_attention_grad_zeroed``, the MiT's attention with a backward
    that returns zeros; ``bn_running_stats``, the head's BatchNorm on its
    running statistics in training, which it does not update;
    ``dwconv_grad_zeroed``, a zero gradient for every Mix-FFN depthwise
    conv's weight; ``masks_all_kept``, the drop-path and dropout draws
    all 0, so that every mask keeps all (the recorded masks, which the
    reference applies too, are those)."""
    if fault is None:
        return step
    import segmif_tpu_torch.models.mit as mit
    import segmif_tpu_torch.models.segformer_head as head

    def zeros(shape, gen, device):
        return torch.zeros(shape, device=device)

    swaps = {"sr_attention_grad_zeroed": [
        (mit, "sr_attention", train_fusion._grad_zeroed(mit.sr_attention))],
        "bn_running_stats": [(head, "batch_norm_train",
                              _bn_on_running_stats)],
        "masks_all_kept": [(mit, "uniform", zeros), (head, "uniform", zeros)]}

    def wrapped(st, batch, seed, shard=None):
        if fault == "half_batch":
            h = batch["image"].shape[0] // 2
            return step(st, {k: torch.cat([v[:h], v[:h]])
                             for k, v in batch.items()}, seed, shard)
        if fault == "dwconv_grad_zeroed":
            hooks = [t.register_hook(torch.zeros_like)
                     for n, t in st.params.items() if n.endswith(DWCONV)]
            try:
                return step(st, batch, seed, shard)
            finally:
                for h in hooks:
                    h.remove()
        if fault in swaps:
            plain = [(mod, name, getattr(mod, name))
                     for mod, name, _ in swaps[fault]]
            for mod, name, swap in swaps[fault]:
                setattr(mod, name, swap)
            try:
                return step(st, batch, seed, shard)
            finally:
                for mod, name, fn in plain:
                    setattr(mod, name, fn)
        if fault != "unchanged":
            raise ValueError(f"unknown fault {fault!r}")
        with torch.no_grad():
            keep = [t.clone() for t in _state_tensors(st)]
        count, host = st.step, st.host_step
        out = step(st, batch, seed, shard)
        with torch.no_grad():
            for t, k in zip(_state_tensors(st), keep):
                t.copy_(k)
        st.step, st.host_step = count, host
        return out

    return wrapped


def _state_tensors(st) -> List[torch.Tensor]:
    o = st.opt_state
    return (list(st.params.values()) + list(st.batch_stats.values())
            + list(o.mu.values()) + list(o.nu.values()) + [o.count])


def first_steps(step, st, batches, p: Dict, draws: int) -> Dict:
    """Drive the step through the compared steps; the readings, on the
    host: each step's loss and masks, the first gradient (the
    optimizer's first moment after one step over 1 - beta1), each leaf's
    change in the first step and over the steps, the head BatchNorm's
    buffers before and after."""
    start = {n: t.detach().clone() for n, t in st.params.items()}
    stats0 = _host(st.batch_stats)
    losses, masks, grads, first = [], [], None, None
    for i, batch in enumerate(batches):
        with recorded_masks() as got:
            m = step(st, batch, draws)
        losses.append(m["loss"])
        masks.append(step_masks(got))
        del got
        if i == 0:
            b1 = p["betas"][0]
            grads = {n: (mu / (1 - b1)).float().cpu()
                     for n, mu in st.opt_state.mu.items()}
            first = leaf_norms({n: st.params[n] - start[n] for n in start})
            stats = _host(st.batch_stats)
    change = leaf_norms({n: st.params[n] - start[n] for n in start})
    return {"losses": torch.stack(losses).tolist(), "masks": masks,
            "grads": grads, "first_change_norms": first,
            "change_norms": change, "stats0": stats0, "stats": stats,
            "stats_steps": _host(st.batch_stats)}


def _host(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().double().cpu() for n, t in stats.items()}


def _quantile(values: List[float], q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(q * len(v)))]


def family(name: str) -> str:
    """A leaf's family: its name with the block's index in its stage left
    out (``encoder.block3.*.mlp.dwconv.dwconv.weight`` holds 40 leaves of
    MiT-B5); a leaf outside the blocks is a family of its own."""
    return re.sub(r"(block\d+)\.\d+\.", r"\1.*.", name)


def leaf_errors(got: Dict, ref: Dict):
    """The first gradient's ||program - reference|| of every leaf whose
    reference norm is at least ``TINY_LEAF`` of the median leaf's, the
    reference norms of all, and the median: (err, norms, median)."""
    gn = {n: float(g.double().norm()) for n, g in ref["grads"].items()}
    med = statistics.median(gn.values())
    err = {}
    for n, v in gn.items():
        if v >= TINY_LEAF * med:
            r = ref["grads"][n]
            err[n] = float((got["grads"][n].to(r.device).double()
                            - r.double()).norm())
    return err, gn, med


def family_errors(err: Dict[str, float], gn: Dict[str, float]
                  ) -> Dict[str, float]:
    """{family: ||first gradient - reference's|| over ||reference's||},
    each over the family's leaves in ``err`` taken together."""
    sums: Dict[str, List[float]] = {}
    for n in err:
        s = sums.setdefault(family(n), [0.0, 0.0])
        s[0] += err[n] ** 2
        s[1] += gn[n] ** 2
    return {f: math.sqrt(e / r) for f, (e, r) in sums.items()}


def mask_keep_z(masks: List[Dict], keep: Dict) -> float:
    """The larger |z| of the compared steps' kept draws against the
    reference's keep probabilities (``keep``): drop-path's over every
    block, sample and step together, dropout's over every element (a
    binomial's mean and variance; 0 where a rate is 0)."""
    kept = mean = var = 0.0
    for m in masks:
        if len(m["drop_path"]) != len(keep["drop_path"]):
            raise ValueError(f"{len(m['drop_path'])} drop-path masks a step,"
                             f" the schedule's {len(keep['drop_path'])}")
        for mask, p in zip(m["drop_path"], keep["drop_path"]):
            n = mask.numel()
            kept += float(mask.double().sum())
            mean, var = mean + n * p, var + n * p * (1.0 - p)
    zs = [abs(kept - mean) / math.sqrt(var)] if var > 0.0 else []
    p = keep["dropout"]
    if p is not None:
        if any(m["dropout"] is None for m in masks):
            raise ValueError("a step drew no dropout mask")
        n = sum(m["dropout"].numel() for m in masks)
        kept = sum(int(m["dropout"].sum()) for m in masks)
        zs.append(abs(kept - n * p) / math.sqrt(n * p * (1.0 - p)))
    return max(zs, default=0.0)


def compare(got: Dict, ref: Dict) -> Dict[str, float]:
    """The program's readings against the reference's: the steps'
    losses, the first gradient's error per leaf (the head's weights, each
    family's, over every leaf), the leaves' changes, the BatchNorm
    buffers, the masks' keep counts. A cell's limits name the ones
    compared."""
    err, gn, med = leaf_errors(got, ref)
    keep = list(err)
    out = {"mask_keep_z": mask_keep_z(got["masks"], ref["keep"])}
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                 ref["losses"])]
    out["loss_rel_gap"], out["loss_rel_gap_first"] = max(gaps), gaps[0]
    out["head_grad_rel_err"] = max(err[n] / gn[n] for n in HEAD if n in err)
    rel = [err[n] / max(gn[n], med) for n in keep]
    out["grad_rel_err_all_median"] = statistics.median(rel)
    out["grad_rel_err_all_p90"] = _quantile(rel, 0.9)
    out["grad_rel_err_all_worst"] = max(rel)
    out["grad_rel_err_family_worst"] = max(
        family_errors(err, gn).values())
    for name, key in (("update_norm_gap", "first_change_norms"),
                      ("update_norm_gap_steps", "change_norms")):
        g = train_fusion.leaf_gaps(got[key], ref[key], keep)
        out[name + "_all_median"] = statistics.median(g)
        out[name + "_all_worst"] = max(g)
    for suffix, key, k in (("", "stats", 1),
                           ("_steps", "stats_steps", len(got["losses"]))):
        for name in STATS:
            n = name[len("seg."):]
            held = BN_MOMENTUM ** k * got["stats0"][n]
            gap = float((got[key][n] - ref[key][n]).norm()
                        / (ref[key][n] - held).norm())
            out["bn_" + n.rsplit(".", 1)[-1] + "_gap" + suffix] = gap
    return out


CHECK_WHAT = {
    "loss_rel_gap_first": "relative gap of the first step's loss",
    "loss_rel_gap": "largest relative gap of a compared step's loss",
    "head_grad_rel_err": "the worse of the head's linear_fuse.conv and "
                         "linear_pred weights: ||first gradient - "
                         "reference's|| over ||reference's||",
    "grad_rel_err_all_median": "median over every leaf of ||first gradient "
                               "- reference's|| over max(its reference "
                               "norm, the median leaf's)",
    "grad_rel_err_all_p90": "90th percentile over every leaf of ||first "
                            "gradient - reference's|| over max(its "
                            "reference norm, the median leaf's)",
    "grad_rel_err_all_worst": "worst leaf of ||first gradient - "
                              "reference's|| over max(its reference norm, "
                              "the median leaf's)",
    "grad_rel_err_family_worst": "worst family (the leaves that differ in "
                                 "their block's index only) of ||first "
                                 "gradient - reference's|| over "
                                 "||reference's||, over its leaves",
    "mask_keep_z": "the larger |z| of the compared steps' kept drop-path "
                   "and dropout draws against the reference's keep "
                   "probabilities",
    "update_norm_gap_all_median": "median over every leaf of its gap of "
                                  "the norm of its change in the first "
                                  "step, over max(its, the median leaf's)",
    "bn_running_mean_gap": "the head BatchNorm's running mean after the "
                           "first step: ||program - reference|| over the "
                           "reference's change",
}


def checks_of(numbers: Dict[str, float], limits: Dict) -> List[Dict]:
    return [{"name": n, "value": numbers.get(n), "limit": limits[n],
             "what": CHECK_WHAT[n]} for n in limits]


def reference(cfg: Dict, p: Dict, seed: int, device, masks: List[Dict],
              precision: str = "float32") -> Dict:
    """The reference's readings of the compared steps, from the seed and
    the program's masks."""
    with strict_float32():
        sd = state.make_state(cfg, seed, device, torch.float32)
        pool = seg_pool(seed, p, cfg, device)
        out = seg_readings(cfg, sd, hyper(p), pool[:p["check_steps"]],
                           masks, precision)
        del sd, pool
    return out


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def accounted(step, on: bool):
    """The step as ``train_fusion.train_window`` calls a fusion step,
    with the port's span accounting on (``on``) for the calls outside a
    profiled stretch."""
    from segmif_tpu_torch.utils.profiler import spans_on

    def call(st, batch, draws, shard=None):
        if on and not _profiling():
            with spans_on():
                return step(st, batch, draws, shard)
        return step(st, batch, draws, shard)

    return call


def setup(cfg: Dict, p: Dict, seed: int, device,
          fault: Optional[str] = None):
    """The step, its state, the batch pool and the base seed of the
    step's draws; then the compared steps, driven through the step
    itself. Returns (step, state, batches, draws, readings, marked
    layers)."""
    master = DTYPES[cfg["train_master_dtype"]]
    model = build_model(cfg, state.make_state(cfg, seed, device, master),
                        device, master)
    step, st = make_step(cfg, p, model, device)
    step = faulty(step, fault)
    batches = seg_pool(seed, p, cfg, device)
    draws = state.sub_seed(seed, DRAWS)
    readings = first_steps(step, st, batches[:p["check_steps"]], p, draws)
    marked = {"seg_head": [model.seg.denoise_net.decoder]}
    return step, st, batches, draws, readings, marked


def run(cell: Cell) -> Outcome:
    from segmif_tpu_torch.utils.profiler import span_totals

    cfg, p, dev = cell.config, cell.params, cell.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    step, st, batches, draws, readings, marked = setup(
        cfg, p, cell.seed, dev, cell.fault)
    for i in range(p["warmup_steps"]):
        step(st, batches[(p["check_steps"] + i) % len(batches)], draws)
    harness.synchronize(dev)
    if cell.trace and dev.type == "cuda":
        trace.Profile.warm_up()
    setup_s = time.time() - cell.t0_wall
    before = span_totals()
    w = train_fusion.train_window(
        accounted(step, cell.trace), st, batches, {"fusion_scale": draws},
        cell.seconds, dev, stretch={"units": p["trace_steps"], "at": 0.25}
        if cell.trace else None, marked=marked)
    after = span_totals()
    peak = harness.memory_peak(dev)
    del step, st, batches, marked
    harness.free_memory(dev)
    ref = reference(cfg, p, cell.seed, dev, readings["masks"])
    numbers = compare(readings, ref)
    del ref
    b = p["global_batch"]
    e2e = {"train_pairs_per_s": (w["steps"] * b / w["seconds"], "pairs/s"),
           "peak_mem_gib": (peak / harness.GIB, "GiB"),
           "setup_s": (setup_s, "s")}
    run_ = None
    if cell.trace and w["trace"] is not None:
        run_ = trace.TracedRun(
            "train", [w["trace"]], w["units"], b,
            3 * seg_flops(cfg, cfg["height"], cfg["width"]), 1,
            w["dispatch_ms"], (w["steps"] - w["units"]) * b,
            w["seconds"] - w["stretch_s"])
        run_.span_totals = {
            n: (ns - before.get(n, (0, 0))[0], c - before.get(n, (0, 0))[1])
            for n, (ns, c) in after.items()
            if c != before.get(n, (0, 0))[1]}
    return Outcome(e2e, w["steps"] * b, w["failed"] * b, peak,
                   checks_of(numbers, cell.limits), run_)
