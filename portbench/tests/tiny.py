"""A configuration and cells at a size the CPU tests can hold: the
benchmark's configuration and traffic files with MiT-B0's widths and
depths, 64 x 64 frames, batch 2, float32 (the kernels' plain versions run
on the CPU)."""
from __future__ import annotations

import copy
from typing import Dict

from portbench import harness


def config(name: str = "segmif_mit_b3_vga") -> Dict:
    cfg = harness.load("configs", name)
    cfg.update(name="tiny", backbone="mit_b0", embed_dims=[32, 64, 160, 256],
               depths=[2, 2, 2, 2], height=64, width=64,
               serve_dtype="float32", train_compute_dtype="float32")
    return cfg


def workload(name: str) -> Dict:
    w = copy.deepcopy(harness.load("workloads", name))
    p = w["params"]
    if w["driver"] == "serve_closed":
        p.update(batch=2, sample_batches=2, warmup_batches=1,
                 trace_batches=2)
    else:
        p.update(global_batch=2 * (w["chips"] if w["chips"] > 1 else 1),
                 micro_batch=1, warmup_steps=0, trace_steps=1, threads=1)
    return w
