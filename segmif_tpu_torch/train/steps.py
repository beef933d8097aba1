"""The fusion-phase training step (counterpart of
``segmif_tpu/train/steps.py::make_fusion_train_step``).

One step: IR + VIS + guide + label -> the fusion forward with the frozen
seg network's taps of the guide -> round 1: L1 + Sobel; rounds >= 2:
MSE + SSIM and cross-entropy through the frozen seg network, combined by
the on-device DWA -> one AdamW update of the fusion parameters. The CE
gradient flows *through* the frozen seg network into the fused image; no
seg parameter takes a gradient.

Precision: bf16 compute with f32 master weights (the JAX package trains
f32 params with bf16 compute). The state's parameters are the f32 fusion
module's own; each step casts them to the compute dtype inside the graph
(``torch.func.functional_call`` runs the module on the casts), so the
kernels see bf16 and the gradients land on the f32 leaves through the
casts. The frozen seg network is a copy in the compute dtype, in eval mode
(running BatchNorm statistics, no dropout), as the JAX step runs it
deterministic. The losses are computed in f32 on the fused Y. With an f64
compute dtype (the parity tests) the master weights and the losses are
f64 too, as the kernels' plain versions then are.

On the card the forward launches the hand-written kernels: sr-attention
in every MiT block (guide taps and the seg pass), the FFM grams and apply,
the DRDB growth and tail. Their backward passes recompute the plain
PyTorch versions (each kernel's ``torch.autograd.Function``, as the JAX
package's ``custom_vjp``s recompute through XLA); the backward launches no
kernel. Nothing waits for the device: the losses come back as device
tensors, the DWA buffer and the optimizer's count live on the device.

``make_fusion_train_chunk`` (K steps as one ``lax.scan``, a dispatch
saving on the TPU) is not ported: the port runs the per-step loop, which
``tests/test_chunked_train.py`` pins as the same maths.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict

import torch
from torch.func import functional_call

from .._device import place, resolve
from ..kernels import _build
from ..losses.dwa import dwa_combine
from ..losses.fusion_losses import fusion_loss_l1_grad, fusion_loss_mse_ssim
from ..losses.seg_loss import cross_entropy
from ..ops.color import rgb_to_ycrcb, ycrcb_to_rgb
from ..ops.image import resize_bilinear
from .state import FusionTrainState


def make_fusion_train_step(model, tx, round1: bool, ignore_index: int = 255,
                           seg_scale: float = 0.8,
                           dwa_temperature: float = 1000.0,
                           dwa_warmup_steps: int = 10, grad_accum: int = 1,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           device=None) -> Callable:
    """model: ``JointPipeline``; tx: ``optimizer.AdamW`` (anything with
    ``update(grads, opt_state, params) -> opt_state``). Returns
    ``step(state, batch, fusion_scale) -> metrics``.

    The model's fusion network moves to the device in f32 (the master
    weights; f64 for an f64 ``compute_dtype``) and is trained in place;
    build the state from it after this call (``FusionTrainState.create(model.fusion, tx)``). The seg network
    is copied, frozen, in ``compute_dtype``; the caller's stays as it was.

    batch: {'ir': [B,H,W,1], 'vis': [B,H,W,3], 'guide': [B,H,W,3] (the
    fusion target and the taps' source), 'label': [B,H,W] int} in [0,1].
    With ``grad_accum`` A > 1 every field has a leading micro-batch dim
    [A, B, ...]: the step takes the mean of the A micro-batch gradients
    and losses and applies one update (the DWA weights come from the first
    micro-batch). fusion_scale: a float or a device scalar (0.4 per round
    in the reference). metrics: {'loss', 'loss_fusion', 'loss_seg',
    'weights'}, device tensors.

    ``device=None`` means ``cuda`` (raises when there is none);
    ``device="cpu"`` trains through the kernels' plain versions."""
    dev = resolve(device)
    acc = _build.acc_dtype(compute_dtype)   # master weights and losses
    fusion = place(model.fusion, dev).to(acc)
    if any(d.quant != "none" for d in fusion.drdbs()):
        raise ValueError("training needs the DRDBs in quant mode 'none'")
    seg = place(copy.deepcopy(model.seg), dev).to(compute_dtype).eval()
    seg.requires_grad_(False)

    def loss_fn(state: FusionTrainState, mb: Dict[str, torch.Tensor],
                fusion_scale):
        with torch.no_grad():
            tap1, tap2 = seg.encode_taps_raw(mb["guide"])
        vis_ycrcb = rgb_to_ycrcb(mb["vis"])
        guide_y = rgb_to_ycrcb(mb["guide"])[..., 0:1]
        weights = {n: p.to(compute_dtype) for n, p in state.params.items()}
        fused_y = functional_call(fusion, weights, (
            mb["ir"], vis_ycrcb[..., 0:1], tap1, tap2)).to(acc)
        if round1:
            loss = fusion_loss_l1_grad(mb["ir"], vis_ycrcb, fused_y, guide_y)
            return (loss, loss, torch.zeros((), device=dev),
                    torch.ones(2, device=dev))
        loss1 = fusion_loss_mse_ssim(mb["ir"], vis_ycrcb, fused_y, guide_y)
        # the unclipped RGB recombination, as the reference feeds its seg
        # loss (train.py:363-368)
        fused_rgb = ycrcb_to_rgb(torch.cat([fused_y, vis_ycrcb[..., 1:]],
                                           dim=-1))
        logits = resize_bilinear(seg(fused_rgb).to(acc),
                                 mb["label"].shape[1:3])
        loss2 = cross_entropy(logits, mb["label"], ignore_index)
        total, _, w = dwa_combine(state.dwa, loss1, loss2, fusion_scale,
                                  seg_scale, dwa_temperature,
                                  dwa_warmup_steps)
        return total, loss1, loss2, w

    def grads_of(state, mb, fusion_scale):
        total, loss1, loss2, w = loss_fn(state, mb, fusion_scale)
        grads = torch.autograd.grad(total, list(state.params.values()))
        return grads, [t.detach() for t in (total, loss1, loss2, w)]

    def step(state: FusionTrainState, batch: Dict[str, torch.Tensor],
             fusion_scale) -> Dict[str, torch.Tensor]:
        if state.step.device.type != dev.type:
            raise ValueError(f"the state is on {state.step.device}, the step "
                             f"on {dev}: create the state after "
                             "make_fusion_train_step")
        batch = {k: v.to(dev) for k, v in batch.items()}
        if grad_accum > 1:
            gsum = sums = None
            for a in range(grad_accum):
                g, ls = grads_of(state, {k: v[a] for k, v in batch.items()},
                                 fusion_scale)
                if gsum is None:
                    gsum, sums, w = list(g), ls[:3], ls[3]
                else:
                    gsum = [x + y for x, y in zip(gsum, g)]
                    sums = [x + y for x, y in zip(sums, ls[:3])]
            inv = 1.0 / grad_accum
            grads = [g * inv for g in gsum]
            total, loss1, loss2 = (s * inv for s in sums)
        else:
            grads, (total, loss1, loss2, w) = grads_of(state, batch,
                                                       fusion_scale)
        state.opt_state = tx.update(dict(zip(state.params, grads)),
                                    state.opt_state, state.params)
        _, state.dwa, _ = dwa_combine(state.dwa, loss1, loss2, fusion_scale,
                                      seg_scale, dwa_temperature,
                                      dwa_warmup_steps)
        state.step = state.step + 1
        return {"loss": total, "loss_fusion": loss1, "loss_seg": loss2,
                "weights": w}

    return step
