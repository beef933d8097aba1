"""CLI: check reference ``.pth`` checkpoints against the port's modules
(counterpart of ``segmif_tpu/cli/convert_checkpoint.py``).

The JAX package converts the reference's torch checkpoints into its own
format. The port's modules carry the reference key layout, so the files
load as they are (``cli.test_fusion``, the trainer's role checkpoints);
this command converts nothing. It loads each given file and compares its
keys and shapes with a freshly built module's ``state_dict``:

    python -m segmif_tpu_torch.cli.convert_checkpoint \\
        --torch_fusion_ckpt modelfusion-final2.pth \\
        --torch_seg_ckpt model-fusion_add_final2.pth --backbone mit_b3

 - ``--torch_fusion_ckpt``: against ``JointPipeline.fusion``;
 - ``--torch_seg_ckpt``: against ``JointPipeline.seg`` (the reference's
   Network3, ``denoise_net.*``);
 - ``--torch_encoder_ckpt``: an ImageNet MiT checkpoint against the
   encoder, ``head.*`` dropped (an encoder key the file lacks is missing;
   extra keys are listed but allowed, as ``load_pretrained_encoder``
   allows them).

It prints the missing keys, the unexpected keys and the shape mismatches
of each file and exits non-zero if any file does not match.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List

SHOWN = 20   # keys listed per kind of difference


def compare(got: Dict, want: Dict) -> Dict[str, List[str]]:
    """Missing keys, unexpected keys and shape mismatches of a state dict
    ``got`` against the module's ``want``."""
    return {
        "missing": sorted(set(want) - set(got)),
        "unexpected": sorted(set(got) - set(want)),
        "shape": sorted(f"{k}: file {tuple(got[k].shape)}, module "
                        f"{tuple(want[k].shape)}" for k in set(got) & set(want)
                        if tuple(got[k].shape) != tuple(want[k].shape)),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--torch_fusion_ckpt", default=None)
    p.add_argument("--torch_seg_ckpt", default=None)
    p.add_argument("--torch_encoder_ckpt", default=None)
    p.add_argument("--backbone", default="mit_b3")
    p.add_argument("--num_classes", type=int, default=9)
    args = p.parse_args(argv)

    import torch

    from ..models.network import JointPipeline

    model = JointPipeline(args.backbone, args.num_classes)
    checks = (("fusion", args.torch_fusion_ckpt, model.fusion, True),
              ("seg", args.torch_seg_ckpt, model.seg, True),
              ("encoder", args.torch_encoder_ckpt,
               model.seg.denoise_net.encoder, False))
    ok, any_file = True, False
    for role, path, module, strict in checks:
        if not path:
            continue
        any_file = True
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if not strict:
            sd = {k: v for k, v in sd.items() if not k.startswith("head.")}
        diff = compare(sd, module.state_dict())
        bad = diff["missing"] or diff["shape"] or (
            strict and diff["unexpected"])
        print(f"{role} {path}: {len(sd)} tensors; "
              f"{'MISMATCH' if bad else 'matches'} the port's {role} "
              f"({args.backbone}, {args.num_classes} classes)")
        for kind, keys in diff.items():
            for k in keys[:SHOWN]:
                print(f"  {kind}: {k}")
            if len(keys) > SHOWN:
                print(f"  {kind}: ... and {len(keys) - SHOWN} more")
        ok &= not bad
    if not any_file:
        p.error("give --torch_fusion_ckpt, --torch_seg_ckpt or "
                "--torch_encoder_ckpt")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
