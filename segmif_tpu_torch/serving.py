"""Serving for the port (counterpart of ``segmif_tpu/serving.py``).

 - ``precompute_guide_taps``: run the seg encoder once (stages 1-2) on a
   static guide image.
 - ``quantize_for_serving``: calibrate the fusion DRDBs on one batch and
   return an int8 copy of the model.
 - ``make_serving_fn``: the closure ``(ir, vis) -> (fused_rgb, pred)``.
   Without a guide, the guide is the VIS frame, re-encoded per pair; with
   one, its taps are computed once and reused for every pair.

Each entry point runs on the card unless the caller asks for the CPU:
``device=None`` means ``cuda`` (and raises when there is no CUDA device),
``device="cpu"`` serves on the CPU through the kernels' plain versions.
The model is moved there (channels_last on the card, the trunk's layout);
inputs are moved there too. Everything runs under
``torch.inference_mode()`` in the model's dtype.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional, Tuple

import torch

from ._device import place, resolve as _device
from .ops.image import resize_bilinear


def _place(model, dev: torch.device):
    return place(model, dev).eval()


def precompute_guide_taps(model, guide_rgb: torch.Tensor, device=None):
    """(tap1, tap2) of the guide at the encoder stages' native
    resolution, ready to pass as ``taps=``. Moves the model to the
    device."""
    dev = _device(device)
    _place(model, dev)
    with torch.inference_mode():
        return model.guide_taps_raw(guide_rgb.to(dev))


def quantize_for_serving(model, calibration_pairs: Tuple[torch.Tensor,
                                                         torch.Tensor],
                         guide_rgb: Optional[torch.Tensor] = None,
                         vis_channel: str = "r", device=None):
    """A copy of ``model`` whose fusion DRDBs run calibrated int8
    (``kernels.int8``); the caller's model is left as it was.

    calibration_pairs: ``(ir, vis)`` of representative inputs (one batch is
    enough: the scales are per-tensor abs-maxes). One ``fuse`` pass (with
    ``guide_rgb``, if given) in calibrate mode records them; then each DRDB
    quantises and packs its weights once."""
    dev = _device(device)
    qmodel = _place(copy.deepcopy(model), dev)
    ir, vis = (t.to(dev) for t in calibration_pairs)
    qmodel.set_quant("calibrate")
    with torch.no_grad():
        qmodel.fuse(ir, vis, guide_rgb=None if guide_rgb is None
                    else guide_rgb.to(dev), vis_channel=vis_channel)
    qmodel.set_quant("int8")
    return qmodel


def make_serving_fn(model, guide_rgb: Optional[torch.Tensor] = None,
                    with_seg: bool = True, vis_channel: str = "r",
                    int8_calibration: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None,
                    device=None) -> Callable:
    """ir: [B,H,W,1] f32 in [0,1]; vis: [B,H,W,3] f32 in [0,1]. Returns
    ``(fused_rgb, pred)`` on the serving device, with pred the int32 class
    map at full resolution (the argmax of the 1/4-res logits upsampled
    bilinearly), or just ``fused_rgb`` when ``with_seg=False``.

    ``int8_calibration=(ir_cal, vis_cal)`` serves a calibrated int8 copy of
    the model (``quantize_for_serving``); otherwise the model itself is
    moved to the device and served."""
    dev = _device(device)
    model = (_place(model, dev) if int8_calibration is None else
             quantize_for_serving(model, int8_calibration, guide_rgb,
                                  vis_channel, dev))
    taps = None
    if guide_rgb is not None:
        taps = precompute_guide_taps(model, guide_rgb, dev)

    def serve(ir: torch.Tensor, vis: torch.Tensor):
        with torch.inference_mode():
            ir, vis = ir.to(dev), vis.to(dev)
            fused_rgb, _ = model.fuse(ir, vis, taps=taps,
                                      vis_channel=vis_channel)
            if not with_seg:
                return fused_rgb
            logits = model.seg(fused_rgb).float()
            logits = resize_bilinear(logits, ir.shape[1:3])
            return fused_rgb, logits.argmax(dim=-1).to(torch.int32)

    return serve
