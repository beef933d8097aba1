"""CLI: export the serving pipeline as a ``torch.export`` program (``.pt2``)
from checkpoints (counterpart of ``segmif_tpu/cli/export.py``).

    python -m segmif_tpu_torch.cli.export \\
        --torch_fusion_ckpt checkpoint/modelfusion-final2.pth \\
        --torch_seg_ckpt checkpoint/model-fusion_add_final2.pth \\
        --out segmif_serve.pt2 --batch 8 --height 480 --width 640 \\
        --static_guide guide.png

The whole inference pipeline (guide taps, fusion net, YCrCb recombination,
segmentation, class-map upsampling) at static shapes, with its weights,
the static guide's taps and the DRDBs' packed kernel weights inside
(``serving.export_serving_artifact``). Weights load as
``cli.test_fusion`` loads them (``--checkpoint_dir`` role files, or the
reference ``.pth`` files); none given keeps seeded random weights.
``--int8`` calibrates the fusion DRDBs on ``--calib_ir``/``--calib_vis``,
or on the static guide (else uniform noise) with uniform-noise IR.

Load side (needs torch and this package's kernels, which register the
``segmif::`` operators and build their library at the first launch):

    import torch, segmif_tpu_torch.kernels
    fn = torch.export.load("segmif_serve.pt2").module()
    with torch.inference_mode():
        fused_rgb, pred = fn(ir, vis)

Departures from the JAX CLI: the JAX artifact is self-contained
StableHLO, lowered for ``--platforms``; a ``.pt2`` calls the port's
operators and runs on the device it was exported for, picked with
``--device`` (``--platforms`` is refused). A static guide or calibration
image is repeated to ``--batch``, the guide batch serving needs.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from .test_fusion import add_runtime_args, build_model, runtime


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", required=True, help="artifact output path")
    p.add_argument("--backbone", default="mit_b3")
    p.add_argument("--num_classes", type=int, default=9)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--torch_fusion_ckpt", default=None)
    p.add_argument("--torch_seg_ckpt", default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--static_guide", default=None,
                   help="path to the per-dataset guide image; its encoder "
                        "taps are precomputed and carried by the artifact")
    p.add_argument("--platforms", default=None,
                   help="not taken: the artifact runs on --device")
    p.add_argument("--fuse_only", action="store_true",
                   help="export fusion only (no segmentation head)")
    p.add_argument("--vis_channel", default="r", choices=["r", "y"])
    p.add_argument("--int8", action="store_true",
                   help="quantize the fusion DRDBs to calibrated int8 "
                        "(kernels/int8.py); calibration uses --calib_ir/"
                        "--calib_vis images, or the static guide / random "
                        "data as fallback")
    p.add_argument("--calib_ir", default=None,
                   help="IR image for int8 calibration")
    p.add_argument("--calib_vis", default=None,
                   help="VIS image for int8 calibration")
    add_runtime_args(p)
    args = p.parse_args(argv)
    if args.platforms is not None:
        raise ValueError("--platforms: a .pt2 program runs on the device it "
                         "was exported for; pick it with --device (cuda or "
                         "cpu)")

    import numpy as np
    import torch

    from .. import serving
    from ..data.datasets import _load_image

    dev, dtype, _ = runtime(args)
    model = build_model(args.backbone, args.num_classes, args.checkpoint_dir,
                        args.torch_fusion_ckpt,
                        args.torch_seg_ckpt).to(dtype)

    def load01(path, gray: bool):
        a = np.asarray(_load_image(Path(path), gray_to_rgb=not gray),
                       np.float32)
        if a.max() > 1.5:
            a = a / 255.0
        if gray:
            a = a[..., :1]
        return torch.from_numpy(np.ascontiguousarray(a))[None]

    def batched(t):
        return t.expand(args.batch, *t.shape[1:]).contiguous()

    guide = None
    if args.static_guide:
        guide = batched(load01(args.static_guide, gray=False))
    int8_calibration = None
    if args.int8:
        if args.calib_ir and args.calib_vis:
            ir_cal = load01(args.calib_ir, gray=True)
            vis_cal = load01(args.calib_vis, gray=False)
        else:
            # fallback: calibrate on the guide (or uniform noise); the
            # amaxes only need a representative dynamic range of [0,1]
            rng = np.random.default_rng(0)
            vis_cal = (guide[:1] if guide is not None else torch.from_numpy(
                rng.uniform(0, 1, (1, args.height, args.width, 3))
                .astype(np.float32)))
            ir_cal = torch.from_numpy(rng.uniform(
                0, 1, (1, args.height, args.width, 1)).astype(np.float32))
        int8_calibration = (batched(ir_cal), batched(vis_cal))
    data = serving.export_serving_artifact(
        model, args.batch, args.height, args.width, guide_rgb=guide,
        with_seg=not args.fuse_only, vis_channel=args.vis_channel,
        int8_calibration=int8_calibration, device=dev)
    serving.save_serving_artifact(args.out, data)
    specs = serving.serving_input_specs(args.out)
    print(f"wrote {args.out}: {len(data) / 1e6:.1f} MB, inputs {specs}, "
          f"device {dev.type}, {str(dtype).split('.')[-1]}")
    return specs


if __name__ == "__main__":
    main()
