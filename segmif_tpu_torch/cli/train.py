"""CLI: interactive fusion <-> segmentation training on the card
(counterpart of ``segmif_tpu/cli/train.py``, with the same flags plus
``--device``, ``--synthetic_val``, ``--dump_fused_images`` and
``--no_native_loader``).

    python -m segmif_tpu_torch.cli.train --data_root ./data/train_all \\
        --val_root ./data/test_all --checkpoint_dir ./checkpoint

trains on two folders in the Infrared / Visible / Mask2 / Label layout
(``data.datasets.FusionFolderDataset``; the directory names from the
config's ``data.*_dir``); ``--streaming`` keeps them on disk
(``train.streaming``), reading per batch through the native C++ loader
unless ``--no_native_loader`` is given (without its library, which needs
the libpng and libjpeg headers, the run raises). ``--synthetic N`` trains
on procedurally generated data instead (N training samples,
``--synthetic_val`` validation samples, N // 4 by default).

The run is on the card unless ``--device cpu`` is given; without a card
and without ``--device cpu`` it raises. On the CPU the compute dtype
defaults to float32, on the card to bfloat16. The log goes to stdout and
to ``train.log`` in the checkpoint dir.

Data parallelism over N ranks (``train.interactive``; N ranks train as one
process on the whole batch):

    torchrun --standalone --nproc_per_node N \
        -m segmif_tpu_torch.cli.train --mesh_data N ...

or, without torchrun, ``--mesh_data N`` alone: the CLI spawns the N ranks
itself (``parallel.dist.launch``). On P hosts of L ranks each, run on
host h (0 <= h < P)

    torchrun --nnodes P --node_rank h --nproc_per_node L \
        --master_addr HOST0 --master_port PORT \
        -m segmif_tpu_torch.cli.train --mesh_data -1 ...

The config's batch sizes stay global: each host reads B/P rows from its
stride of the names, and the global batch is the hosts' batches in host
order. If every host sees the same ``--checkpoint_dir`` rank 0 writes the
files; else each host's first rank writes its host's copy there and
resumes from it (``train.interactive``). Tensor parallelism over M ranks
a model group (``parallel.tensor``): ``--mesh_model M``, with
``--mesh_data D`` on D x M ranks (``--mesh_data -1``, the default, is
every rank over M; a model group lies within a host);
alone, the CLI spawns D x M ranks (M with ``--mesh_data -1``). Rank r
computes on ``cuda:r % device_count`` (``--device cpu``: the CPU); the
ranks talk over NCCL when each has a card of its own and over gloo when
they share one or run on the CPU (``parallel.dist.choose_backend``). Only
the ranks that write files log at INFO (and to ``train.log``).
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None, help="seg-task YAML")
    p.add_argument("--configf", default=None, help="fusion-task YAML")
    p.add_argument("--backbone", default=None)
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--data_root", default=None)
    p.add_argument("--val_root", default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic samples instead of real data")
    p.add_argument("--synthetic_val", type=int, default=None,
                   help="synthetic validation samples (default N // 4, at "
                        "least 1)")
    p.add_argument("--synthetic_size", type=int, nargs=2, default=(480, 640))
    p.add_argument("--fusion_iters", type=int, default=None)
    p.add_argument("--seg_iters", type=int, default=None)
    p.add_argument("--crop_size", type=int, default=None,
                   help="override crop size for BOTH phases (e.g. for small "
                        "synthetic images)")
    p.add_argument("--start_round", type=int, default=1,
                   help="resume from this round (loads checkpoints)")
    p.add_argument("--remat", action="store_true",
                   help="not ported (refused)")
    p.add_argument("--mesh_data", type=int, default=-1,
                   help="ranks of the data axis, over every host (-1: "
                        "every launched rank); N > 1 without torchrun "
                        "spawns N ranks")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="ranks of a model group (tensor parallelism), "
                        "within one host; without torchrun D x M ranks "
                        "are spawned")
    p.add_argument("--streaming", action="store_true",
                   help="keep the splits on disk (decode per batch; fused "
                        "images in a disk memmap)")
    p.add_argument("--no_native_loader", action="store_true",
                   help="streaming: read through Python threads, not the "
                        "native C++ loader")
    p.add_argument("--dump_fused_images", action="store_true",
                   help="write each round's regenerated fused images as "
                        "PNGs under the checkpoint dir")
    p.add_argument("--fusion_chunk", type=int, default=None,
                   help="not ported: > 1 is refused")
    p.add_argument("--compute_dtype", default=None,
                   choices=("bfloat16", "float32"),
                   help="activation dtype; default bfloat16 on the card, "
                        "float32 on the CPU")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    from ..parallel.dist import run_cli

    ranks = max(args.mesh_data, 1) * args.mesh_model
    return run_cli(ranks, args.device, lambda c: _run(args, c), _rank,
                   argv)


def _rank(comm, argv):
    """One spawned rank of ``--mesh_data N`` / ``--mesh_model M``."""
    return _run(_parse(argv), comm)


def _run(args, comm=None):
    """The run on this process; ``comm``: the group of every rank under
    data or tensor parallelism."""
    from ..config import TrainConfig, load_yaml
    from ..data.datasets import FusionFolderDataset, SyntheticFusionDataset
    from ..train.interactive import InteractiveTrainer
    from ..utils.logging import setup_logger

    cfg = load_yaml(args.config, args.configf) if args.config else \
        TrainConfig()
    if args.backbone:
        cfg.backbone = args.backbone
    if args.rounds:
        cfg.rounds = args.rounds
    if args.data_root:
        cfg.data.root_dir = args.data_root
    if args.val_root:
        cfg.data.val_root_dir = args.val_root
    if args.checkpoint_dir:
        cfg.checkpoint_dir = args.checkpoint_dir
    if args.fusion_iters:
        cfg.fusion.iters_round1 = cfg.fusion.iters_later = args.fusion_iters
    if args.seg_iters:
        cfg.seg.iters = args.seg_iters
    if args.crop_size:
        cfg.fusion.crop_size = args.crop_size
        cfg.data.crop_size = args.crop_size
    if args.fusion_chunk:
        cfg.fusion.train_chunk = args.fusion_chunk
    if args.remat:
        cfg.remat = True
    if args.streaming:
        cfg.streaming = True
    if args.no_native_loader:
        cfg.native_loader = False
    if args.dump_fused_images:
        cfg.dump_fused_images = True
    if args.compute_dtype:
        cfg.compute_dtype = args.compute_dtype
    elif args.device == "cpu" and cfg.compute_dtype == "bfloat16":
        cfg.compute_dtype = "float32"
    cfg.mesh_data = args.mesh_data
    cfg.mesh_model = args.mesh_model

    Path(cfg.checkpoint_dir).mkdir(parents=True, exist_ok=True)
    log_file = str(Path(cfg.checkpoint_dir) / "train.log")
    # under ranks the trainer names the writers; until then only warnings
    logger = setup_logger(log_file) if comm is None else \
        setup_logger(level=logging.WARNING)
    if args.synthetic:
        size = tuple(args.synthetic_size)
        n_val = args.synthetic_val or max(args.synthetic // 4, 1)
        train_ds = SyntheticFusionDataset(args.synthetic, size,
                                          cfg.data.num_classes, seed=0)
        val_ds = SyntheticFusionDataset(n_val, size, cfg.data.num_classes,
                                        seed=1)
    else:
        d = cfg.data
        train_ds, val_ds = (FusionFolderDataset(
            root, ir_dir=d.ir_dir, vis_dir=d.vis_dir, guide_dir=d.guide_dir,
            label_dir=d.label_dir) for root in (d.root_dir, d.val_root_dir))
    trainer = InteractiveTrainer(cfg, train_ds, val_ds, logger=logger,
                                 device=args.device if comm is None
                                 else comm.device)
    if comm is not None and trainer.writer:
        setup_logger(log_file)   # the same logger, now at INFO
    logger.info("files: %s", trainer.writer_rule)
    if not args.synthetic:
        logger.info("folder data: %d training pairs in %s, %d validation "
                    "pairs in %s", len(train_ds), d.root_dir, len(val_ds),
                    d.val_root_dir)
    result = trainer.run(start_round=args.start_round)
    logger.info("training complete: best mIoU %.4f", result["best_mIoU"])
    return result


if __name__ == "__main__":
    main()
