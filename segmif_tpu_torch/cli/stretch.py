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

Departure from the JAX CLI: ``--spatial`` (row shards of the fusion
trunk) defaults to 1, the plain fuse on one device; the JAX CLI defaults
to 8. N > 1 is refused: spatial row sharding is ROADMAP queue 1's
"Spatial row sharding" item, not ported yet.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Tuple

from .test_fusion import add_runtime_args, runtime

SPATIAL_REFUSAL = ("--spatial N > 1: the row-sharded fusion trunk "
                   "(parallel/spatial.py) is not ported; it is ROADMAP "
                   "queue 1's \"Spatial row sharding\" item")


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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="configs/stretch_1080p.yaml")
    p.add_argument("--spatial", type=int, default=1,
                   help="row shards for the fusion trunk: 1, the plain "
                        "fuse (N > 1 is not ported)")
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
    if args.spatial != 1:
        raise ValueError(SPATIAL_REFUSAL)

    import torch

    from ..config import load_yaml
    from ..models.network import JointPipeline, init_params

    dev, dtype, acc = runtime(args)
    cfg = load_yaml(args.config)
    if args.backbone:
        cfg.backbone = args.backbone
    h, w = args.size if args.size else cfg.data.resize_range
    print(f"stretch config: backbone={cfg.backbone} "
          f"classes={cfg.data.num_classes} resolution={h}x{w} "
          f"spatial shards={args.spatial} device={dev.type} "
          f"dtype={str(dtype).split('.')[-1]}", flush=True)

    t0 = time.perf_counter()
    model = init_params(JointPipeline(cfg.backbone, cfg.data.num_classes,
                                      cfg.embedding_dim),
                        torch.Generator().manual_seed(0))
    print(f"params initialized in {time.perf_counter() - t0:.1f}s",
          flush=True)
    fuse_fn, seg_fn = make_stretch_fns(model, dtype, dev)
    clock = _clock(dev)

    if args.synthetic or not args.data_root:
        ir, vis = synthetic_pair(h, w)
        ir, vis = ir.to(dev), vis.to(dev)
        for i in range(2):   # rep 0 warms up; rep 1 is the steady state
            stop = clock()
            fused, _ = fuse_fn(ir, vis, vis)
            tf = stop()
            logits, ts = None, 0.0
            if not args.no_seg:
                stop = clock()
                logits = seg_fn(fused)
                ts = stop()
            tag = "warm-up" if i == 0 else "steady-state"
            print(f"[{tag}] fuse {tf:.0f} ms"
                  + ("" if args.no_seg else f", seg {ts:.0f} ms"),
                  flush=True)
        print(f"fused shape {tuple(fused.shape)}"
              + ("" if logits is None else
                 f", logits shape {tuple(logits.shape)}"))
        print("stretch 1080p OK", flush=True)
        return fused, logits

    from ..data.datasets import FusionFolderDataset
    from ..eval.evaluator import generate_fused

    ds = FusionFolderDataset(args.data_root)
    names, fused, _ = generate_fused(fuse_fn, ds, batch_size=1,
                                     out_dir=args.out_dir, device=dev,
                                     dtype=acc)
    print(f"fused {len(names)} images at {h}x{w} -> {args.out_dir}")
    return names, fused


if __name__ == "__main__":
    main()
