"""CLI: fusion inference over a test folder, writing fused RGB PNGs
(counterpart of ``segmif_tpu/cli/test_fusion.py``; the reference's
test_fusion.py).

    python -m segmif_tpu_torch.cli.test_fusion --data_root ./test_all \\
        --checkpoint_dir ./checkpoint --out_dir ./Fused_images

Builds ``JointPipeline`` at full width, loads the trainer's role
checkpoints from ``--checkpoint_dir`` (``fusion_params.pth``,
``seg_params.pth``) or reference ``.pth`` files (``--torch_fusion_ckpt``,
``--torch_seg_ckpt``; the port's modules carry the reference key layout,
so they load as they are), fuses every (IR, VIS) pair of the folder with
the seg encoder's taps of its guide image, and writes
``<out_dir>/<name>``, each batch quantised together (``eval.image_io``;
``--reference_quantization`` for the reference's double truncation).

``--static_guide IMAGE`` computes the guide's taps once from IMAGE
(``serving.precompute_guide_taps``) and broadcasts them to every batch.
``--spatial N > 0`` fuses with the fusion trunk's rows split over N ranks
(``parallel.spatial.make_spatial_fuse_fn``): under torchrun
(``torchrun --standalone --nproc_per_node N -m
segmif_tpu_torch.cli.test_fusion --spatial N ...``), else on N ranks the
CLI spawns (one rank: in this process); rank 0 writes the PNGs. Each
image's rows per rank must be at least 16; ``--static_guide`` is not
taken with it.

The run is on the card unless ``--device cpu`` is given (without a card it
raises); the compute dtype defaults to bfloat16 on the card and float32 on
the CPU.
"""
from __future__ import annotations

import argparse
import copy
import logging
import sys
from pathlib import Path
from typing import Callable, Optional

DTYPE_CHOICES = ("bfloat16", "float32")


def add_runtime_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--compute_dtype", default=None, choices=DTYPE_CHOICES,
                   help="activation dtype; default bfloat16 on the card, "
                        "float32 on the CPU")


def runtime(args, comm=None):
    """(device, compute dtype, input dtype) from ``--device`` (or the
    device of ``comm``'s rank) and ``--compute_dtype``; raises without a
    card unless ``--device cpu``."""
    import torch

    from .._device import resolve
    from ..kernels import _build

    dev = resolve(args.device if comm is None else comm.device)
    name = args.compute_dtype or ("float32" if dev.type == "cpu"
                                  else "bfloat16")
    dtype = getattr(torch, name)
    return dev, dtype, _build.acc_dtype(dtype)


def build_model(backbone: str, num_classes: int,
                checkpoint_dir: Optional[str] = None,
                torch_fusion_ckpt: Optional[str] = None,
                torch_seg_ckpt: Optional[str] = None, seed: int = 0):
    """A full-width ``JointPipeline`` (f32, on the CPU) with weights from
    the given files: the reference ``.pth`` files first, then the role
    checkpoints of ``checkpoint_dir`` where they exist; weights no file
    gives keep the seeded initialisation (and a warning says so)."""
    import torch

    from ..models.network import JointPipeline, init_params
    from ..train import checkpoint as ckpt
    from ..train.interactive import ROLE_FILES

    log = logging.getLogger("segmif_tpu_torch")
    model = init_params(JointPipeline(backbone, num_classes),
                        torch.Generator().manual_seed(seed))
    files = {"fusion": torch_fusion_ckpt, "seg": torch_seg_ckpt}
    if checkpoint_dir:
        for role, name in ROLE_FILES.items():
            if (Path(checkpoint_dir) / name).exists():
                files[role] = str(Path(checkpoint_dir) / name)
    for role, path in files.items():
        if path:
            ckpt.load_role(path, getattr(model, role))
            log.info("%s weights from %s", role, path)
        else:
            log.warning("no %s checkpoint: %s keeps random weights (seed "
                        "%d)", role, role, seed)
    return model.eval()


def make_static_guide_fuse_fn(model, guide_rgb01, compute_dtype,
                              device) -> Callable:
    """``fuse(ir, vis, guide) -> (fused_rgb, fused_y)`` that ignores the
    per-sample guide: the taps of ``guide_rgb01`` [1,H,W,3] are computed
    once, on a copy of ``model`` in ``compute_dtype``, and broadcast to
    each batch."""
    import torch

    from .._device import place
    from ..kernels import _build
    from ..serving import precompute_guide_taps

    acc = _build.acc_dtype(compute_dtype)
    infer = place(copy.deepcopy(model), device).to(compute_dtype).eval()
    taps = precompute_guide_taps(infer, guide_rgb01.to(device, acc), device)

    def fuse(ir, vis, guide):
        b = ir.shape[0]
        bt = tuple(t.expand(b, *t.shape[1:]).contiguous() for t in taps)
        with torch.inference_mode():
            return infer.fuse(ir.to(device, acc), vis.to(device, acc),
                              taps=bt)

    return fuse


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--ir_dir", default="Infrared")
    p.add_argument("--vis_dir", default="Visible")
    p.add_argument("--guide_dir", default="Mask2")
    p.add_argument("--label_dir", default="Label")
    p.add_argument("--out_dir", default="Fused_images")
    p.add_argument("--checkpoint_dir", default="./checkpoint")
    p.add_argument("--torch_fusion_ckpt", default=None)
    p.add_argument("--torch_seg_ckpt", default=None)
    p.add_argument("--backbone", default="mit_b3")
    p.add_argument("--num_classes", type=int, default=9)
    p.add_argument("-B", "--batch_size", type=int, default=4)
    p.add_argument("--reference_quantization", action="store_true",
                   help="reproduce the reference's double uint8 "
                        "quantization")
    p.add_argument("--spatial", type=int, default=0, metavar="N",
                   help="split the fusion trunk's rows over N ranks")
    p.add_argument("--static_guide", default=None, metavar="IMAGE",
                   help="compute the guide's seg-encoder taps ONCE from "
                        "this image and reuse them for every pair")
    add_runtime_args(p)
    return p.parse_args(argv)


def _dataset(args):
    from ..data.datasets import FusionFolderDataset

    return FusionFolderDataset(args.data_root, ir_dir=args.ir_dir,
                               vis_dir=args.vis_dir,
                               guide_dir=args.guide_dir,
                               label_dir=args.label_dir)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    if args.spatial > 0:
        from ..parallel.dist import run_cli
        from ..parallel.spatial import row_blocks

        if args.static_guide:
            raise ValueError("--static_guide is not taken with --spatial")
        ds = _dataset(args)
        if len(ds):   # every rank holds >= 16 rows of each image
            row_blocks(ds[0][1].shape[0], args.spatial)
        return run_cli(args.spatial, args.device, lambda c: _run(args, c),
                       _rank, argv)
    return _run(args)


def _rank(comm, argv):
    """One spawned rank of ``--spatial N``."""
    return _run(_parse(argv), comm)


def _run(args, comm=None):
    import torch

    from ..data.datasets import _load_image
    from ..eval.evaluator import generate_fused
    from ..parallel.mesh import make_mesh
    from ..parallel.spatial import make_spatial_fuse_fn
    from ..train.steps import make_fuse_fn

    dev, dtype, acc = runtime(args, comm)
    model = build_model(args.backbone, args.num_classes, args.checkpoint_dir,
                        args.torch_fusion_ckpt, args.torch_seg_ckpt)
    ds = _dataset(args)
    out_dir = args.out_dir
    if args.spatial > 0:
        fuse_fn = make_spatial_fuse_fn(make_mesh(args.spatial, comm=comm),
                                       model, dtype, dev)
        if comm is not None and comm.rank > 0:
            out_dir = None   # rank 0 writes
    elif args.static_guide:
        guide = _load_image(Path(args.static_guide), gray_to_rgb=True)
        fuse_fn = make_static_guide_fuse_fn(
            model, torch.from_numpy(guide)[None] / 255.0, dtype, dev)
    else:
        fuse_fn = make_fuse_fn(model, dtype, dev)
    names, _, _ = generate_fused(
        fuse_fn, ds, batch_size=args.batch_size, out_dir=out_dir,
        quantize_like_reference=args.reference_quantization, device=dev,
        dtype=acc)
    if out_dir is not None:
        print(f"fused {len(names)} images -> {out_dir}")
    return names


if __name__ == "__main__":
    main()
