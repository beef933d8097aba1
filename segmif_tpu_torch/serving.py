"""Serving for the port (counterpart of ``segmif_tpu/serving.py``).

 - ``precompute_guide_taps``: run the seg encoder once (stages 1-2) on a
   static guide image.
 - ``make_serving_fn``: the closure ``(ir, vis) -> (fused_rgb, pred)``.
   Without a guide, the guide is the VIS frame, re-encoded per pair; with
   one, its taps are computed once and reused for every pair.

Everything runs under ``torch.inference_mode()`` on the model's device and
dtype: CUDA tensors go through the hand-written kernels, CPU tensors
through their plain versions.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .ops.image import resize_bilinear


def precompute_guide_taps(model, guide_rgb: torch.Tensor):
    """(tap1, tap2) of the guide at the encoder stages' native
    resolution, ready to pass as ``taps=``."""
    with torch.inference_mode():
        return model.guide_taps_raw(guide_rgb)


def make_serving_fn(model, guide_rgb: Optional[torch.Tensor] = None,
                    with_seg: bool = True,
                    vis_channel: str = "r") -> Callable:
    """ir: [B,H,W,1] f32 in [0,1]; vis: [B,H,W,3] f32 in [0,1], on the
    model's device. Returns ``(fused_rgb, pred)`` with pred the int32 class
    map at full resolution (the argmax of the 1/4-res logits upsampled
    bilinearly), or just ``fused_rgb`` when ``with_seg=False``."""
    model.eval()
    taps = None
    if guide_rgb is not None:
        taps = precompute_guide_taps(model, guide_rgb)

    def serve(ir: torch.Tensor, vis: torch.Tensor):
        with torch.inference_mode():
            fused_rgb, _ = model.fuse(ir, vis, taps=taps,
                                      vis_channel=vis_channel)
            if not with_seg:
                return fused_rgb
            logits = model.seg(fused_rgb).float()
            logits = resize_bilinear(logits, ir.shape[1:3])
            return fused_rgb, logits.argmax(dim=-1).to(torch.int32)

    return serve
