"""The readings that the seg-phase cell's correctness limits are set from
(``drivers/train_seg.py``), at the cell's own size, in one process:

    python3 -m portbench.calibrate_seg --workload <cell> --seeds 1-6 \
        [--control_seeds 1-2] [--fault_seeds 1-2] [--faults a,b] \
        [--out FILE]

For each seed, the compared numbers of:

 - ``program``: the port as the cell runs it, through its compared steps
   (its sound readings; the largest over the seeds is a limit's lower
   reading);
 - ``control_fp8``, which must come out not correct: the reference put in
   the program's place with every product's operands, and every value it
   makes, in float8 e4m3 (the precision below the configuration's
   bfloat16); ``reference_bf16`` beside it, a witness: the same in
   bfloat16;
 - the planted faults (``train_seg.FAULTS``, or ``--faults``):
   ``unchanged``, ``half_batch``, ``sr_attention_grad_zeroed`` (the MiT
   attention's backward returning zeros), ``bn_running_stats`` (the
   head's BatchNorm on its running statistics in training),
   ``dwconv_grad_zeroed`` (the Mix-FFN depthwise convs' weights without
   a gradient) and ``masks_all_kept`` (drop-path and dropout keeping
   all).

Each side is held against the float32 reference computed with that
side's own drop-path and dropout masks, by the cell's own comparison
(``train_seg.compare``); sides that drew the same masks share one
reference. One JSON line per seed and side (with its three worst
gradient families and its worst leaf), then a summary line per number:
the largest sound (and witness) reading and the smallest of each other
side's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import torch

from . import harness
from .calibrate import seeds, summary
from .drivers import train_seg


def _same_masks(a: List[Dict], b: List[Dict]) -> bool:
    def flat(ms):
        return [t for m in ms for t in m["drop_path"] + [m["dropout"]]]

    fa, fb = flat(a), flat(b)
    return len(fa) == len(fb) and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and torch.equal(x, y))
        for x, y in zip(fa, fb))


def side(cfg, p, seed, dev, fault=None) -> Dict:
    step, st, batches, _, readings, _ = train_seg.setup(cfg, p, seed, dev,
                                                        fault)
    del step, st, batches
    harness.free_memory(dev)
    return readings


def readings(cfg, p, seed, dev, control: bool, faults) -> Dict[str, Dict]:
    """({side: compared numbers}, {side: ``worst_of``}) of one seed."""
    sides = {"program": side(cfg, p, seed, dev)}
    for f in faults:
        sides[f] = side(cfg, p, seed, dev, f)
    refs: List = []          # (masks, reference readings)

    def ref_of(masks):
        for m, r in refs:
            if _same_masks(m, masks):
                return r
        r = train_seg.reference(cfg, p, seed, dev, masks)
        refs.append((masks, r))
        return r

    out = {s: train_seg.compare(r, ref_of(r["masks"]))
           for s, r in sides.items()}
    worst = {s: worst_of(r, ref_of(r["masks"])) for s, r in sides.items()}
    if control:
        masks = sides["program"]["masks"]
        ref = ref_of(masks)
        for name, kind in (("control_fp8", "float8_e4m3"),
                           ("reference_bf16", "bfloat16")):
            low = train_seg.reference(cfg, p, seed, dev, masks, kind)
            out[name] = train_seg.compare(low | {"masks": masks}, ref)
            worst[name] = worst_of(low, ref)
            del low
            harness.free_memory(dev)
    return out, worst


def worst_of(got: Dict, ref: Dict) -> Dict:
    """Where the gradient numbers come from: the three worst families
    and the worst leaf (over max(its norm, the median leaf's))."""
    err, gn, med = train_seg.leaf_errors(got, ref)
    fam = train_seg.family_errors(err, gn)
    leaf = max(err, key=lambda n: err[n] / max(gn[n], med))
    return {"families": sorted(fam.items(), key=lambda kv: -kv[1])[:3],
            "leaf": [leaf, err[leaf] / max(gn[leaf], med), gn[leaf] / med]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--fault_seeds", default="")
    ap.add_argument("--faults", default="",
                    help="the faults to plant, comma-separated (default: "
                         "all the driver's)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    wl = harness.load("workloads", args.workload)
    cfg = harness.load("configs", wl["config"])
    p = wl["params"]
    ctl, flt = set(seeds(args.control_seeds)), set(seeds(args.fault_seeds))
    faults = (tuple(args.faults.split(",")) if args.faults
              else train_seg.FAULTS)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.time()
    lines = []
    for seed in seeds(args.seeds):
        nums, worst = readings(cfg, p, seed, dev, seed in ctl,
                               faults if seed in flt else ())
        for name, n in nums.items():
            ln = {"workload": args.workload, "seed": seed, "side": name,
                  "numbers": n, "worst": worst[name],
                  "at_s": round(time.time() - t0, 1)}
            lines.append(ln)
            print(json.dumps(ln), flush=True)
    for row in summary(lines):
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
