"""CLI: segmentation eval over a folder of (fused) images (counterpart of
``segmif_tpu/cli/test_segmentation.py``; the reference's
test_segmentation.py).

    python -m segmif_tpu_torch.cli.test_segmentation \\
        --fused_dir ./Fused_images --label_dir ./test_all/Label \\
        --checkpoint_dir ./checkpoint

Loads the seg weights as ``cli.test_fusion`` does, segments every image of
``--fused_dir`` (naturally sorted; ``data.datasets.MethodFolderDataset``),
prints the per-class precision / IoU table and the mIoU, appends the table
to ``--log_file``, and returns the result dict of
``eval.evaluator.segmentation_eval``. On the card unless ``--device cpu``
is given.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fused_dir", required=True)
    p.add_argument("--label_dir", required=True)
    p.add_argument("--checkpoint_dir", default="./checkpoint")
    p.add_argument("--torch_seg_ckpt", default=None)
    p.add_argument("--backbone", default="mit_b3")
    p.add_argument("--num_classes", type=int, default=9)
    p.add_argument("-B", "--batch_size", type=int, default=4)
    p.add_argument("--log_file", default="val_seg.txt")
    from .test_fusion import add_runtime_args, build_model, runtime

    add_runtime_args(p)
    args = p.parse_args(argv)

    from ..data.datasets import MethodFolderDataset
    from ..eval.evaluator import segmentation_eval
    from ..eval.metrics import MFNET_CLASS_NAMES
    from ..train.steps import make_segment_fn

    dev, dtype, acc = runtime(args)
    model = build_model(args.backbone, args.num_classes, args.checkpoint_dir,
                        torch_seg_ckpt=args.torch_seg_ckpt)
    ds = MethodFolderDataset(args.fused_dir, args.label_dir)
    res = segmentation_eval(make_segment_fn(model.seg, dtype, dev), ds,
                            args.num_classes, args.batch_size,
                            log_file=args.log_file, tag=args.fused_dir,
                            device=dev, dtype=acc)
    names = (MFNET_CLASS_NAMES if args.num_classes == len(MFNET_CLASS_NAMES)
             else [f"class{i}" for i in range(args.num_classes)])
    print(f"{'class':<12} {'precision':>10} {'iou':>10}")
    for i, n in enumerate(names):
        print(f"{n:<12} {res['precision'][i]:>10.4f} {res['iou'][i]:>10.4f}")
    print(f"mIoU {res['mIoU']:.4f}  pixel_acc {res['pixel_acc']:.4f}")
    return res


if __name__ == "__main__":
    main()
