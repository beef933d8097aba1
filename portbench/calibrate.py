"""The readings that a cell's correctness limits are set from, at the
cell's own size, in one process (one set of ranks for a four-chip cell):

    python3 -m portbench.calibrate --workload <cell> --seeds 1-12 \
        [--control_seeds 1-3] [--fault_seeds 1-3] [--faults a,b] \
        [--window_s 3] [--out FILE]

For each seed, the compared numbers of:

 - ``program``: the port as the cell runs it (its sound readings; the
   largest over the seeds is a limit's lower reading);
 - the control, which must come out not correct: ``control_fp8``, the
   reference put in the program's place with every product's operands in
   float8 e4m3 (the precision below the configuration's bfloat16), and for
   a serving cell ``control_int8``, the port's own lower-precision path
   (calibrated int8 DRDBs, ``serving.quantize_for_serving``);
 - the planted faults the cell can have: serving ``answer`` and
   ``half_batch``; training ``unchanged``, ``half_batch``,
   ``drdb_grad_zeroed`` and ``ffm_grad_zeroed`` (the DRDBs' or the FFM's
   backward returning zeros); data parallel training also
   ``no_exchange`` (the gradient all-reduce left out). ``--faults``
   names a subset.

A serving side runs a closed-loop window of ``--window_s`` seconds as
the cell runs its own, and keeps the sample that the cell's check keeps;
a training side drives its compared steps. The reference, float32, is
computed once per seed and held against every side by the cell's own
comparison. One JSON line per seed and side, then a summary line per
number: the largest sound reading and the smallest of each other side's.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import harness, state
from .drivers import serve_closed, train_fusion
from .program import DTYPES, build_model


def seeds(text: str) -> List[int]:
    out: List[int] = []
    for part in text.split(","):
        if "-" in part[1:]:
            a, b = part.split("-", 1)
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


# each driver's planted faults
FAULTS = {"serve_closed": ("answer", "half_batch"),
          "train_fusion": ("unchanged", "half_batch", "drdb_grad_zeroed",
                           "ffm_grad_zeroed")}
FAULTS["train_fusion_dp"] = FAULTS["train_fusion"] + ("no_exchange",)


# ------------------------------------------------------------------ serving

def serve_sides(cfg, p, seed, dev, control: bool, faults: Sequence[str],
                seconds: float) -> Dict[str, list]:
    """{side: kept (pool index, slot) pairs} of the program's sides, each
    from a closed-loop window of ``seconds`` driven as the cell drives
    its own (``serve_closed.serve_window``) and sampled as the cell
    samples it."""
    from segmif_tpu_torch.serving import make_serving_fn

    b, h, w = p["batch"], cfg["height"], cfg["width"]
    dtype = DTYPES[cfg["serve_dtype"]]
    model = build_model(cfg, state.make_state(cfg, seed, dev, dtype), dev,
                        dtype)
    pool = state.serve_pool(seed, p["pool"], b, h, w, dev)
    serve = make_serving_fn(model, device=dev)
    fns = {"program": serve}
    for f in faults:
        fns[f] = serve_closed.faulty(serve, f, cfg["num_classes"])
    if control:
        cal = pool[0]
        fns["control_int8"] = make_serving_fn(
            model, int8_calibration=(cal["ir"], cal["vis"]), device=dev)
    kept: Dict[str, list] = {}
    for side, fn in fns.items():
        for i in range(p["warmup_batches"]):
            fn(**pool[i % len(pool)])
        harness.synchronize(dev)
        slots = [serve_closed.Slot(b, h, w, dev)
                 for _ in range(p["in_flight"] + p["sample_batches"] + 1)]
        keep = serve_closed.Reservoir(p["sample_batches"],
                                      np.random.default_rng(state.sub_seed(
                                          seed, state.SAMPLE)))
        serve_closed.serve_window(fn, pool, slots, seconds, p["in_flight"],
                                  keep, dev)
        kept[side] = keep.kept
    del model, pool, serve, fns
    harness.free_memory(dev)
    return kept


def serve_readings(cfg, p, seed, dev, control, faults,
                   seconds: float = 3.0) -> Dict[str, Dict]:
    """Each side's compared numbers, by the cell's own check
    (``serve_closed.reference_checks``) in one reference pass; with
    ``control``, the reference in float8 e4m3 besides."""
    kept = serve_sides(cfg, p, seed, dev, control, faults, seconds)
    return serve_closed.reference_checks(
        cfg, seed, p, kept, dev,
        {"control_fp8": "float8_e4m3"} if control else None)


# ----------------------------------------------------------------- training

def train_side(cfg, p, seed, dev, fault=None) -> Dict:
    step, st, batches, readings, _ = train_fusion.setup(cfg, p, seed, dev,
                                                        fault=fault)
    del step, st, batches
    harness.free_memory(dev)
    return readings


def train_readings(cfg, p, seed, dev, control, faults) -> Dict[str, Dict]:
    sides = {"program": train_side(cfg, p, seed, dev)}
    for f in faults:
        sides[f] = train_side(cfg, p, seed, dev, f)
    ref = train_fusion.reference(cfg, p, seed, dev)
    if control:
        sides["control_fp8"] = train_fusion.reference(cfg, p, seed, dev,
                                                      "float8_e4m3")
        # a witness: the plain maths with bfloat16 operands
        sides["reference_bf16"] = train_fusion.reference(cfg, p, seed, dev,
                                                         "bfloat16")
    return {s: train_fusion.compare(r, ref) for s, r in sides.items()}


def dp_rank(comm, cfg, p, seed_list, control_seeds, fault_seeds, faults):
    """One rank of the four-chip cell's readings: every seed's program
    sides on all ranks, then this rank's share of the references."""
    import segmif_tpu_torch.train.steps as steps
    from segmif_tpu_torch.parallel.mesh import (batch_shard, make_mesh,
                                                put_replicated)

    dev = comm.device
    mesh = make_mesh(-1, 1, comm, device=dev)
    shard = batch_shard(mesh, p["global_batch"])
    summed = steps._sum_over_ranks
    progs: Dict = {}
    for seed in seed_list:
        for f in [None] + (list(faults) if seed in fault_seeds else []):
            steps._sum_over_ranks = (
                (lambda shard_, g, l: (g, l)) if f == "no_exchange"
                else summed)
            step, st, batches, readings, _ = train_fusion.setup(
                cfg, p, seed, dev, rows=shard.take, shard=shard, fault=f,
                replicate=lambda m: put_replicated(mesh, m))
            progs[(seed, f or "program")] = readings
            del step, st, batches
            harness.free_memory(dev)
    steps._sum_over_ranks = summed
    refs = {}
    for seed in seed_list[comm.rank::comm.world]:
        refs[seed] = {"ref": train_fusion.reference(cfg, p, seed, dev)}
        if seed in control_seeds:
            refs[seed]["control_fp8"] = train_fusion.reference(
                cfg, p, seed, dev, "float8_e4m3")
    return {"progs": progs, "refs": refs}


def dp_readings(cfg, p, seed_list, control_seeds, fault_seeds, faults,
                chips=4, device="cuda"):
    from segmif_tpu_torch.parallel.dist import launch

    outs = launch(dp_rank, chips, (cfg, p, seed_list, set(control_seeds),
                                   set(fault_seeds), faults), device=device,
                  timeout=3000, threads=p.get("threads"))
    refs = {}
    for o in outs:
        refs.update(o["refs"])
    result = {}
    for seed in seed_list:
        nums: Dict[str, Dict] = {}
        for o in outs:
            for (s, side), r in o["progs"].items():
                if s != seed:
                    continue
                n = train_fusion.compare(r, refs[seed]["ref"])
                old = nums.setdefault(side, n)
                nums[side] = {k: max(old[k], n[k]) for k in n}
        for side in ("control_fp8", "reference_bf16"):
            if side in refs[seed]:
                nums[side] = train_fusion.compare(refs[seed][side],
                                                  refs[seed]["ref"])
        result[seed] = nums
    return result


def summary(lines: List[Dict]) -> List[Dict]:
    out = []
    numbers = sorted({k for ln in lines for k in ln["numbers"]})
    for name in numbers:
        row = {"number": name}
        for side in sorted({ln["side"] for ln in lines}):
            vals = [ln["numbers"][name] for ln in lines if ln["side"] == side]
            row[side] = (max(vals) if side in ("program", "reference_bf16")
                         else min(vals), len(vals))
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--fault_seeds", default="")
    ap.add_argument("--faults", default="",
                    help="the faults to plant, comma-separated (default: "
                         "all the cell's)")
    ap.add_argument("--window_s", type=float, default=3.0,
                    help="a serving side's window, in seconds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    wl = harness.load("workloads", args.workload)
    cfg = harness.load("configs", wl["config"])
    p = wl["params"]
    all_seeds = seeds(args.seeds)
    ctl, flt = set(seeds(args.control_seeds)), set(seeds(args.fault_seeds))
    faults = (tuple(args.faults.split(",")) if args.faults
              else FAULTS[wl["driver"]])
    dev = torch.device("cuda", 0)
    t0 = time.time()
    lines = []
    if wl["driver"] == "train_fusion_dp":
        per_seed = dp_readings(cfg, p, all_seeds, ctl, flt, faults,
                               wl["chips"]).items()
    else:
        reader = (functools.partial(serve_readings, seconds=args.window_s)
                  if wl["driver"] == "serve_closed" else train_readings)
        per_seed = ((s, reader(cfg, p, s, dev, s in ctl,
                               faults if s in flt else ()))
                    for s in all_seeds)
    for seed, nums in per_seed:
        for side, n in nums.items():
            ln = {"workload": args.workload, "seed": seed, "side": side,
                  "numbers": n, "at_s": round(time.time() - t0, 1)}
            lines.append(ln)
            print(json.dumps(ln), flush=True)
    rows = summary(lines)
    for row in rows:
        print(json.dumps({"summary": row}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for ln in lines:
                f.write(json.dumps(ln) + "\n")
    print(f"card: {torch.cuda.get_device_name(0)}; "
          f"{time.time() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
