"""Traffic ``train_fusion_dp``: the fusion-phase step of ``train_fusion``
under data parallelism, one rank a card over NCCL on one host.

The run spawns ``chips`` ranks through ``segmif_tpu_torch.parallel.dist.
launch`` (a ``file://`` rendezvous in a fresh directory under ``TMPDIR``).
Every rank makes the same weights and global batches from the seed,
replicates the weights as the trainer does (``put_replicated``), takes its
rows of each global batch (``parallel.mesh.batch_shard``) and drives the
step with its shard: the losses and the gradients are summed over the
ranks. Set-up drives the compared steps; rank 0 then times two more and
sets the window's step count, so that every rank runs the same steps for
about ``--seconds``. The window ends in a synchronise and a barrier.

End to end: ``train_pairs_per_s`` counts the global batch;
``peak_mem_gib`` is the fullest card's.

Correctness: every rank's readings of the compared steps against the
reference's single-process steps on the global batches, by
``train_fusion``'s numbers, the worst rank's.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from .. import harness, trace
from ..harness import Cell, Outcome
from ..yardstick.flops import train_flops_per_pair
from . import train_fusion as single

def rank_main(comm, cfg: Dict, p: Dict, seed: int, seconds: float,
              traced: bool, fault: Optional[str]) -> Dict:
    """One rank: set-up, the compared steps, the window. Returns
    picklable readings."""
    import segmif_tpu_torch.train.steps as steps
    from segmif_tpu_torch.parallel.mesh import (batch_shard, make_mesh,
                                                put_replicated)

    dev = comm.device
    if fault == "no_exchange":
        steps._sum_over_ranks = lambda shard, grads, losses: (grads, losses)
    mesh = make_mesh(-1, 1, comm, device=dev)
    shard = batch_shard(mesh, p["global_batch"])
    step, st, batches, readings, marked = single.setup(
        cfg, p, seed, dev, rows=shard.take, shard=shard, fault=fault,
        replicate=lambda model: put_replicated(mesh, model))
    harness.synchronize(dev)
    t = time.perf_counter()
    for i in range(2):
        step(st, batches[(p["check_steps"] + i) % len(batches)],
             p["fusion_scale"], shard)
    harness.synchronize(dev)
    per_step = (time.perf_counter() - t) / 2
    count = torch.tensor([max(2, round(seconds / per_step))],
                         dtype=torch.float64, device=dev)
    comm.broadcast_(count)
    if traced and dev.type == "cuda":
        trace.Profile.warm_up()
    comm.barrier()
    window_wall = time.time()
    w = single.train_window(step, st, batches, p, seconds, dev, shard,
                            {"units": p["trace_steps"], "at": 0.25}
                            if traced else None, marked, int(count.item()))
    comm.barrier()
    return {"readings": readings, "window": w, "window_wall": window_wall,
            "peak": harness.memory_peak(dev),
            "forbidden": harness.forbidden_modules()}


def run(cell: Cell) -> Outcome:
    from segmif_tpu_torch.kernels import _build
    from segmif_tpu_torch.parallel.dist import launch

    cfg, p = cell.config, cell.params
    device = cell.device.type
    if device == "cuda":
        _build.library()     # built once here, not by every rank
    # the rendezvous lives in a fresh directory under TMPDIR
    outs = launch(rank_main, cell.chips,
                  (cfg, p, cell.seed, cell.seconds, cell.trace, cell.fault),
                  device=device, timeout=330, threads=p.get("threads"))
    for r, o in enumerate(outs):
        if o["forbidden"]:
            raise RuntimeError(f"rank {r} loaded {o['forbidden']}")
    ref = single.reference(cfg, p, cell.seed, cell.device)
    numbers = {}
    for o in outs:
        for k, v in single.compare(o["readings"], ref).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    w0 = outs[0]["window"]
    b = p["global_batch"]
    peak = max(o["peak"] for o in outs)
    e2e = {"train_pairs_per_s": (w0["steps"] * b / w0["seconds"], "pairs/s"),
           "peak_mem_gib": (peak / harness.GIB, "GiB"),
           "setup_s": (outs[0]["window_wall"] - cell.t0_wall, "s")}
    run_ = None
    if cell.trace and all(o["window"]["trace"] for o in outs):
        run_ = trace.TracedRun(
            "train", [o["window"]["trace"] for o in outs], w0["units"], b,
            train_flops_per_pair(cfg), cell.chips, w0["dispatch_ms"],
            (w0["steps"] - w0["units"]) * b, w0["seconds"] - w0["stretch_s"])
    failed = max(o["window"]["failed"] for o in outs)
    return Outcome(e2e, w0["steps"] * b, failed * b, peak,
                   single.checks_of(numbers, cell.limits), run_)
