"""CLI: the 1080p/mit_b5 stretch path, full-resolution fusion then
segmentation on one device (counterpart of ``segmif_tpu/cli/stretch.py``).

    # one synthetic 1080p pair on the card (bf16), seeded random weights:
    python -m segmif_tpu_torch.cli.stretch --config configs/stretch_1080p.yaml \\
        --synthetic

    # real data (Infrared/Visible/Mask2 layout), fused PNGs written:
    python -m segmif_tpu_torch.cli.stretch --config configs/stretch_1080p.yaml \\
        --data_root ./test_all --out_dir ./Fused_1080p

    # on the CPU at a small size:
    python -m segmif_tpu_torch.cli.stretch --synthetic --size 64 64 \\
        --backbone mit_b0 --device cpu

``--config`` gives the backbone, the classes and the resolution
(``configs/stretch_1080p.yaml``: mit_b5, 15 classes, 1080x1920); a
``JointPipeline`` takes seeded random weights (seed 0), as the JAX CLI
initialises its own. ``--synthetic`` fuses and segments one pair drawn
from ``np.random.default_rng(0)`` (ir, then vis; the guide is vis), twice:
a warm-up, then the steady-state time (CUDA events on the card, the host
clock on the CPU). ``--data_root`` fuses a folder at batch 1
(``eval.evaluator.generate_fused``) into ``--out_dir``.

The run is on the card unless ``--device cpu`` is given; the compute
dtype defaults to bfloat16 on the card and float32 on the CPU.

``--spatial N`` splits the fusion trunk's rows over N ranks
(``parallel.spatial.make_spatial_fuse_fn``): under torchrun
(``torchrun --standalone --nproc_per_node N -m
segmif_tpu_torch.cli.stretch --spatial N ...``), else on N ranks the CLI
spawns; N = 1 is the plain fuse in this process. N defaults to the
number of cards this process sees (1 on the CPU): the JAX CLI's default
of 8 meant 8 devices, and N ranks that share one card only add the
exchanges' overhead. Rank r computes on ``cuda:r % device_count``; ranks
that share a card talk over gloo, ranks with a card each over NCCL
(``parallel.dist``). Every rank holds at least 16 rows. Rank 0 segments
the gathered fused image, prints and writes; the others only fuse.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Tuple

from .test_fusion import add_runtime_args, runtime


def make_stretch_fns(model, compute_dtype, device) -> Tuple[Callable,
                                                            Callable]:
    """``(fuse, seg)`` on ``model`` (a ``JointPipeline``, placed on
    ``device`` in ``compute_dtype`` and put in eval mode):
    ``fuse(ir, vis, guide) -> (fused_rgb, fused_y)`` (the JAX stretch's
    fuse with one shard) and ``seg(fused_rgb) -> logits`` at 1/4
    resolution, each under ``inference_mode`` on inputs of any batch."""
    import torch

    from .._device import place, resolve
    from ..kernels import _build

    device = resolve(device)
    acc = _build.acc_dtype(compute_dtype)
    model = place(model, device).to(compute_dtype).eval()

    def fuse(ir, vis, guide):
        with torch.inference_mode():
            return model.fuse(ir.to(device, acc), vis.to(device, acc),
                              guide_rgb=guide.to(device, acc))

    def seg(fused_rgb):
        with torch.inference_mode():
            return model.seg(fused_rgb.to(device, acc))

    return fuse, seg


def synthetic_pair(h: int, w: int, batch: int = 1):
    """(ir [B,H,W,1], vis [B,H,W,3]) f32 from ``np.random.default_rng(0)``,
    drawn in the JAX CLI's order."""
    import numpy as np
    import torch

    gen = np.random.default_rng(0)
    ir = gen.uniform(0, 1, (batch, h, w, 1)).astype(np.float32)
    vis = gen.uniform(0, 1, (batch, h, w, 3)).astype(np.float32)
    return torch.from_numpy(ir), torch.from_numpy(vis)


def _clock(dev):
    """A stopwatch: CUDA events on the card, the host clock elsewhere.
    ``start()`` returns a function giving the ms since."""
    import torch

    def start():
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()

            def stop():
                b.record()
                b.synchronize()
                return a.elapsed_time(b)
            return stop
        t0 = time.perf_counter()
        return lambda: (time.perf_counter() - t0) * 1e3
    return start


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="configs/stretch_1080p.yaml")
    p.add_argument("--spatial", type=int, default=None,
                   help="row shards (ranks) for the fusion trunk; 1: the "
                        "plain fuse in this process; default: the cards "
                        "this process sees (1 on the CPU)")
    p.add_argument("--synthetic", action="store_true",
                   help="run on one synthetic pair (no data needed)")
    p.add_argument("--data_root", default=None)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--size", type=int, nargs=2, default=None,
                   metavar=("H", "W"), help="override the config resolution")
    p.add_argument("--backbone", default=None,
                   help="override the config backbone (e.g. mit_b0 for smoke)")
    p.add_argument("--no_seg", action="store_true",
                   help="fusion only (skip the segmentation branch)")
    add_runtime_args(p)
    args = p.parse_args(argv)
    if args.spatial is None:
        import torch

        args.spatial = max(1, torch.cuda.device_count()) \
            if torch.device(args.device).type == "cuda" else 1
    return args


def _config(args):
    """(config, H, W) of the run."""
    from ..config import load_yaml

    cfg = load_yaml(args.config)
    if args.backbone:
        cfg.backbone = args.backbone
    h, w = args.size if args.size else cfg.data.resize_range
    return cfg, h, w


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    if args.spatial > 1:
        from ..parallel.dist import run_cli
        from ..parallel.spatial import row_blocks

        if args.synthetic or not args.data_root:
            row_blocks(_config(args)[1], args.spatial)
        return _from_numpy(run_cli(args.spatial, args.device,
                                   lambda c: _run(args, c), _rank, argv))
    return _run(args)


def _rank(comm, argv):
    """One spawned rank of ``--spatial N``: its result with tensors as
    numpy arrays (rank 0's is returned)."""
    out = _run(_parse(argv), comm)
    return tuple(t.cpu().numpy() if hasattr(t, "numpy") else t for t in out)


def _from_numpy(out):
    import numpy as np
    import torch

    return tuple(torch.from_numpy(t) if isinstance(t, np.ndarray) else t
                 for t in out)


def _run(args, comm=None):
    import torch

    from ..models.network import JointPipeline, init_params

    dev, dtype, acc = runtime(args, comm)
    cfg, h, w = _config(args)
    lead = comm is None or comm.rank == 0   # prints, segments, writes
    say = print if lead else (lambda *a, **k: None)
    say(f"stretch config: backbone={cfg.backbone} "
          f"classes={cfg.data.num_classes} resolution={h}x{w} "
          f"spatial shards={args.spatial} device={dev.type} "
          f"dtype={str(dtype).split('.')[-1]}", flush=True)
    if comm is not None:
        say(f"spatial ranks: {comm.transport}", flush=True)

    t0 = time.perf_counter()
    model = init_params(JointPipeline(cfg.backbone, cfg.data.num_classes,
                                      cfg.embedding_dim),
                        torch.Generator().manual_seed(0))
    say(f"params initialized in {time.perf_counter() - t0:.1f}s",
        flush=True)
    if args.spatial > 1:
        from ..parallel.mesh import make_mesh
        from ..parallel.spatial import make_spatial_fuse_fn

        fuse_fn = make_spatial_fuse_fn(make_mesh(args.spatial, comm=comm),
                                       model, dtype, dev)
        seg_fn = make_stretch_fns(model, dtype, dev)[1] if lead else None
    else:
        fuse_fn, seg_fn = make_stretch_fns(model, dtype, dev)
    clock = _clock(dev)
    if args.no_seg or not lead:
        seg_fn = None

    if args.synthetic or not args.data_root:
        ir, vis = synthetic_pair(h, w)
        ir, vis = ir.to(dev), vis.to(dev)
        for i in range(2):   # rep 0 warms up; rep 1 is the steady state
            stop = clock()
            fused, _ = fuse_fn(ir, vis, vis)
            tf = stop()
            logits, ts = None, 0.0
            if seg_fn is not None:
                stop = clock()
                logits = seg_fn(fused)
                ts = stop()
            tag = "warm-up" if i == 0 else "steady-state"
            say(f"[{tag}] fuse {tf:.0f} ms"
                + ("" if args.no_seg else f", seg {ts:.0f} ms"),
                flush=True)
        say(f"fused shape {tuple(fused.shape)}"
            + ("" if logits is None else
               f", logits shape {tuple(logits.shape)}"))
        say("stretch 1080p OK", flush=True)
        return fused, logits

    from ..data.datasets import FusionFolderDataset
    from ..eval.evaluator import generate_fused

    ds = FusionFolderDataset(args.data_root)
    names, fused, _ = generate_fused(fuse_fn, ds, batch_size=1,
                                     out_dir=args.out_dir if lead else None,
                                     device=dev, dtype=acc)
    say(f"fused {len(names)} images at {h}x{w} -> {args.out_dir}")
    return names, fused


if __name__ == "__main__":
    main()
