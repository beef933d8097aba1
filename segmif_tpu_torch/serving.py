"""Serving for the port (counterpart of ``segmif_tpu/serving.py``).

 - ``precompute_guide_taps``: run the seg encoder once (stages 1-2) on a
   static guide image.
 - ``quantize_for_serving``: calibrate the fusion DRDBs on one batch and
   return an int8 copy of the model.
 - ``make_serving_fn``: the closure ``(ir, vis) -> (fused_rgb, pred)``
   (a ``ServingModule``). Without a guide, the guide is the VIS frame,
   re-encoded per pair; with one, its taps are computed once and reused
   for every pair.
 - ``export_serving_artifact`` / ``save_serving_artifact`` /
   ``load_serving_artifact`` / ``serving_input_specs``: that closure as a
   ``torch.export`` program at static shapes, in ``.pt2`` bytes (the JAX
   package exports StableHLO; a ``.pt2`` calls the ``segmif::``
   operators, so its loader imports ``segmif_tpu_torch.kernels``).

``make_serving_fn(..., mesh=)`` serves one stream on a model group of
ranks (``parallel.mesh``, tensor parallelism: ``parallel.tensor``), the
JAX ``bench.py --mesh_model`` path: every rank of the group passes the
same inputs and returns the same outputs. The model is copied, broadcast
from rank 0, quantised first when int8 (its DRDBs stay whole), then split.

Each entry point runs on the card unless the caller asks for the CPU:
``device=None`` means ``cuda`` (and raises when there is no CUDA device),
``device="cpu"`` serves on the CPU through the kernels' plain versions.
The model is moved there (channels_last on the card, the trunk's layout);
inputs are moved there too. Everything runs under
``torch.inference_mode()`` in the model's dtype.
"""
from __future__ import annotations

import copy
import io
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch

from . import kernels  # noqa: F401 (registers the segmif:: operators)
from ._device import place, resolve as _device
from .ops.image import const, resize_bilinear
from .parallel.mesh import put_replicated
from .parallel.tensor import tensor_parallel
from .utils.profiler import span


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


class ServingModule(torch.nn.Module):
    """The serving closure as a module: ``forward(ir, vis)`` fuses, then
    (``with_seg``) segments the fused image and returns ``(fused_rgb,
    pred)``. ``taps``: the static guide's (tap1, tap2), kept as buffers;
    None re-encodes the VIS frame per pair."""

    def __init__(self, model, taps=None, with_seg: bool = True,
                 vis_channel: str = "r"):
        super().__init__()
        self.model = model
        self.with_seg = with_seg
        self.vis_channel = vis_channel
        for i, t in enumerate((None, None) if taps is None else taps):
            self.register_buffer(f"tap{i + 1}", t, persistent=False)

    def forward(self, ir: torch.Tensor, vis: torch.Tensor):
        with span("serve"):
            taps = None if self.tap1 is None else (self.tap1, self.tap2)
            fused_rgb, _ = self.model.fuse(ir, vis, taps=taps,
                                           vis_channel=self.vis_channel)
            if not self.with_seg:
                return fused_rgb
            logits = self.model.seg(fused_rgb).float()
            logits = resize_bilinear(logits, ir.shape[1:3])
            return fused_rgb, logits.argmax(dim=-1).to(torch.int32)


def _serving_module(model, guide_rgb, with_seg, vis_channel,
                    int8_calibration, dev, mesh=None) -> ServingModule:
    split = mesh is not None and mesh.model > 1
    if int8_calibration is not None:
        model = quantize_for_serving(model, int8_calibration, guide_rgb,
                                     vis_channel, dev)
    else:
        model = _place(copy.deepcopy(model) if split else model, dev)
    if split:
        # the same weights, amaxes and int8 buffers on every rank
        tensor_parallel(put_replicated(mesh, model), mesh)
    taps = None
    if guide_rgb is not None:
        taps = precompute_guide_taps(model, guide_rgb, dev)
    return ServingModule(model, taps, with_seg, vis_channel).eval()


def make_serving_fn(model, guide_rgb: Optional[torch.Tensor] = None,
                    with_seg: bool = True, vis_channel: str = "r",
                    int8_calibration: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None,
                    device=None, mesh=None) -> Callable:
    """ir: [B,H,W,1] f32 in [0,1]; vis: [B,H,W,3] f32 in [0,1]. Returns
    ``(fused_rgb, pred)`` on the serving device, with pred the int32 class
    map at full resolution (the argmax of the 1/4-res logits upsampled
    bilinearly), or just ``fused_rgb`` when ``with_seg=False``.

    ``int8_calibration=(ir_cal, vis_cal)`` serves a calibrated int8 copy of
    the model (``quantize_for_serving``); otherwise the model itself is
    moved to the device and served. ``mesh``: a ``parallel.mesh.Mesh``
    whose model group serves one stream (a split copy of the model; every
    rank of the group calls ``serve`` with the same inputs and gets the
    same outputs); ``device`` is then the rank's."""
    dev = _device(device)
    module = _serving_module(model, guide_rgb, with_seg, vis_channel,
                             int8_calibration, dev, mesh)

    def serve(ir: torch.Tensor, vis: torch.Tensor):
        with torch.inference_mode():
            return module(ir.to(dev), vis.to(dev))

    return serve


def export_serving_artifact(model, batch: int, height: int, width: int,
                            guide_rgb: Optional[torch.Tensor] = None,
                            with_seg: bool = True, vis_channel: str = "r",
                            int8_calibration: Optional[Tuple[
                                torch.Tensor, torch.Tensor]] = None,
                            device=None) -> bytes:
    """The serving closure of ``make_serving_fn`` (same arguments), traced
    by ``torch.export`` at the static shapes ir [batch, height, width, 1]
    and vis [batch, height, width, 3] f32 and serialised as a ``.pt2``
    program: the weights, the static guide's taps and the DRDBs' packed
    kernel weights (float or int8) travel inside it as buffers.

    The kernels stay ``segmif::`` operators in the program: loading it
    needs ``import segmif_tpu_torch.kernels`` (``load_serving_artifact``
    does it), which registers them and builds their library at the first
    launch. The program runs on the device it was exported for. The
    caller's model is not changed: a copy is placed and served."""
    dev = _device(device)
    model = copy.deepcopy(model) if int8_calibration is None else model
    module = _serving_module(model, guide_rgb, with_seg, vis_channel,
                             int8_calibration, dev)
    if dev.type == "cuda":
        dtype = module.model.fusion.conv1_ir.weight.dtype
        for d in module.model.fusion.drdbs():
            if d.quant == "none":
                d.pin_kernel_weights(dtype)
    for name in ("tap1", "tap2"):       # inference tensors cannot be traced
        t = getattr(module, name)
        if t is not None:
            setattr(module, name, t.clone())
    ir = torch.zeros((batch, height, width, 1), device=dev)
    vis = torch.zeros((batch, height, width, 3), device=dev)
    # a constant made while tracing would be a traced value: the cache of
    # ``ops.image.const`` is emptied around the trace
    const.cache_clear()
    try:
        with torch.no_grad():
            program = torch.export.export(module, (ir, vis))
    finally:
        const.cache_clear()
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def save_serving_artifact(path: str | Path, data: bytes) -> None:
    Path(path).write_bytes(data)


def load_serving_artifact(path: str | Path) -> torch.nn.Module:
    """The exported program of a ``.pt2`` file as a module ``(ir, vis)
    -> outputs``, on the device it was exported for, its weights frozen
    (the outputs carry no autograd graph)."""
    return torch.export.load(str(path)).module().requires_grad_(False)


def serving_input_specs(artifact_path: str | Path
                        ) -> Tuple[Tuple[Tuple[int, ...], str], ...]:
    """The artifact's input shapes and dtypes (``"float32"``), read from
    the program's input placeholders without running it."""
    program = torch.export.load(str(artifact_path))
    user = program.graph_signature.user_inputs
    vals = {n.name: n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder"}
    return tuple((tuple(vals[n].shape), str(vals[n].dtype).split(".")[-1])
                 for n in user)


def segmif_nodes(program) -> dict:
    """{operator name: count} of the ``segmif::`` calls in the graph of an
    exported program (a ``torch.export.ExportedProgram``, or the module
    ``load_serving_artifact`` returns)."""
    counts: dict = {}
    for n in program.graph.nodes:
        if n.op == "call_function" and str(n.target).startswith("segmif."):
            name = str(n.target).split(".")[1]
            counts[name] = counts.get(name, 0) + 1
    return counts
