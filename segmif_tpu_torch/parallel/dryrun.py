"""The multi-rank dry run (counterpart of ``__graft_entry__.py:32``
``dryrun_multichip``): on N ranks, one step of each parallel path at tiny
shapes, on the JAX dry run's mesh: data N/2 x model 2 for an even N >= 4
(tensor parallelism, ``parallel.tensor``), else data N x model 1.

    python -m segmif_tpu_torch.parallel.dryrun 2 [--device cpu]
    torchrun --standalone --nproc_per_node 2 \\
        -m segmif_tpu_torch.parallel.dryrun 2

 - one round >= 2 fusion step (the frozen seg network's CE, DWA) of
   mit_b0 at 64x64, one sample a data index, the model split over each
   model group;
 - one seg step (the 3-group AdamW, BatchNorm batch statistics, drop-path
   and dropout);
 - the spatial fuse (``make_spatial_fuse_fn``) of the first pair, its
   rows split over the data axis (16 rows a rank at least: 64 rows up to
   4, 16 D beyond), each model group running its rows split;
 - a mit_b3 forward at 96x128, data x model: the deployed configuration's
   parameter shapes.

Rank 0 prints one line, as the JAX dry run does, with the mesh's axes.
The ranks compute in f32 on the CPU and in bf16 on the card.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .._device import place
from . import dist
from .mesh import Mesh, batch_shard, make_mesh, put_replicated
from .spatial import HALO, make_spatial_fuse_fn
from .tensor import tensor_parallel


def mesh_axes(world: int):
    """(data, model) of the JAX dry run on ``world`` ranks: model 2 for
    an even world of 4 or more."""
    model = 2 if world % 2 == 0 and world >= 4 else 1
    return world // model, model


def _data(b: int, h: int, w: int):
    """The JAX dry run's draws: ir, vis, guide, label from default_rng
    0..3."""
    r = np.random.default_rng
    return {"ir": r(0).uniform(0, 1, (b, h, w, 1)).astype(np.float32),
            "vis": r(1).uniform(0, 1, (b, h, w, 3)).astype(np.float32),
            "guide": r(2).uniform(0, 1, (b, h, w, 3)).astype(np.float32),
            "label": r(3).integers(0, 9, (b, h, w)).astype(np.int64)}


def dryrun(comm: dist.Comm) -> str:
    """Run the dry run's four paths on this rank; returns the line rank 0
    prints."""
    from ..models.network import JointPipeline, init_params
    from ..train.optimizer import adamw_poly, adamw_poly_grouped
    from ..train.state import FusionTrainState, SegTrainState
    from ..train.steps import make_fusion_train_step, make_seg_train_step

    dev = comm.device
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    mesh = make_mesh(*mesh_axes(comm.world), comm=comm)
    n = mesh.data
    h, w = max(64, HALO * n), 64
    model = init_params(JointPipeline("mit_b0", num_classes=9),
                        torch.Generator().manual_seed(0))
    tensor_parallel(put_replicated(mesh, model), mesh)
    data = {k: torch.from_numpy(v) for k, v in _data(n, h, w).items()}
    shard = batch_shard(mesh, n)

    # the fusion-phase step, round >= 2: CE through the frozen seg net, DWA
    ftx = adamw_poly(3e-4, warmup_iter=0, max_iter=1000)
    fstep = make_fusion_train_step(model, ftx, round1=False,
                                   compute_dtype=dtype, device=dev)
    fstate = FusionTrainState.create(model.fusion, ftx)
    fm = fstep(fstate, shard.own(data), 0.4, shard)

    # the seg-phase step: 3-group AdamW, BN batch statistics, dropout
    seg = model.seg
    stx = adamw_poly_grouped([k for k, _ in seg.named_parameters()], 8e-5,
                             warmup_iter=10, max_iter=1000)
    sstep = make_seg_train_step(seg, stx, compute_dtype=dtype, device=dev)
    sstate = SegTrainState.create(seg, stx)
    sm = sstep(sstate, shard.own({"image": data["guide"],
                                   "label": data["label"]}), 1, shard)

    # spatial: the fusion trunk's rows over the data axis
    sp_rgb, sp_y = make_spatial_fuse_fn(Mesh(n, mesh.comm), model, dtype,
                                        dev)(
        data["ir"][:1], data["vis"][:1], data["guide"][:1])

    # the deployed model's parameter shapes: mit_b3, data x model forward
    b3 = init_params(JointPipeline("mit_b3", num_classes=9),
                     torch.Generator().manual_seed(2))
    tensor_parallel(put_replicated(mesh, b3), mesh)
    b3 = place(b3, dev).to(dtype).eval()
    b3_data = _data(n, 96, 128)
    rows = shard.own({k: torch.from_numpy(b3_data[k])
                      for k in ("ir", "vis")})
    with torch.inference_mode():
        _, fy, logits = b3(rows["ir"].to(dev, dtype),
                           rows["vis"].to(dev, dtype))
        sums = torch.stack([fy.float().sum(), logits.float().sum(),
                            torch.tensor(float(logits[..., 0].numel()),
                                         device=dev)]).double()
        if mesh.comm is not None:   # a sample counted once
            mesh.comm.all_reduce_sum_(sums)
    checks = [torch.isfinite(t).all() for t in (fm["loss"], sm["loss"],
                                                 sp_y, sums)]
    if not all(bool(c) for c in checks) or sp_y.shape != (1, h, w, 1):
        raise RuntimeError("dry run: a non-finite result or a wrong shape")
    classes = logits.shape[-1]
    return (f"dryrun OK on {comm.world} ranks ({comm.transport}; mesh "
            f"data={n}, model={mesh.model}): fusion loss "
            f"{float(fm['loss']):.4f}, seg loss {float(sm['loss']):.4f}, "
            f"spatial fused {tuple(sp_y.shape)}, mit_b3 dp x tp forward "
            "logits mean "
            f"{float(sums[1] / (sums[2] * classes)):.4f}")


def _rank(comm, _argv):
    return dryrun(comm)


def main(argv=None) -> str:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("ranks", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.ranks < 2:
        p.error("the dry run spans 2 ranks or more")
    line = dist.run_cli(args.ranks, args.device, dryrun, _rank, argv)
    if dist.env_ranks()[1] == 0:   # rank 0 under torchrun
        print(line, flush=True)
    return line


if __name__ == "__main__":
    main()
