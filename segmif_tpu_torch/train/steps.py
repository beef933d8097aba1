"""The training steps of the two phases and the inference closures of the
interactive driver (counterpart of ``segmif_tpu/train/steps.py``):
``make_fusion_train_step``, ``make_seg_train_step``, ``make_fuse_fn`` and
``make_segment_fn``.

The fusion step:

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

Data parallelism: each step takes a ``shard`` (``parallel.mesh.
BatchShard``) when ranks share the batch, and the batch is then this
rank's rows. N ranks then give the losses, gradients, DWA state and
updated weights that one process gives on the whole batch, as the JAX DP
step gives one device's (tests/test_parallel.py):
 - each rank's loss is its share of the global loss: the pixel-mean
   losses times ``shard.share``, the cross-entropy's sum over the GLOBAL
   count of valid pixels (so the all-ignored -> 0 rule holds on the
   global count);
 - the gradients are summed over the ranks (one all-reduce of all
   leaves), and so are the losses, which the metrics and the DWA buffer
   read: every rank keeps the same weights and task weights;
 - the seg step's BatchNorm normalises with the global batch's
   statistics (``segformer_head.batch_stats``) and its drop-path and
   dropout draw for the global batch and keep the rank's rows.
``grad_accum`` > 1 with a shard raises, as the JAX driver refuses
accumulation under data parallelism.

Tensor parallelism (``parallel.tensor``): the steps take a split model
as they take a whole one. The shard's ``comm`` is then the data group,
so the CE's global count, the BatchNorm statistics and the gradient and
loss sums run over the data group only; the M ranks of a model group
hold the same rows and draw the same masks; a split leaf's gradient is
its piece's, and the whole leaves' gradients are broadcast from the
group's rank 0 (``parallel.tensor.broadcast_whole``: on the card the
group's backward passes are not bit for bit alike), so the whole leaves
stay the same on every rank.

``make_fusion_train_chunk`` (K steps as one ``lax.scan``, a dispatch
saving on the TPU) is not ported: the port runs the per-step loop, which
``tests/test_chunked_train.py`` pins as the same maths.

The seg step: the fused image -> the train-mode segmentation network
(drop-path, dropout, BatchNorm batch statistics folded into the running
buffers) -> f32 logits resized to the label size -> cross-entropy with
the ignore label -> one 3-group AdamW update. Precision as in the fusion
step (bf16 compute on f32 master weights through ``functional_call``;
f64 throughout for an f64 compute dtype). The draws of step s come from a
generator on the device seeded from (base seed, s) (``fold_seed``), the
counterpart of the JAX step's ``fold_in(rng, state.step)``, so a resumed
phase draws what the uninterrupted one drew. On the card the forward
launches the sr-attention kernel in every MiT block; its backward
recomputes the plain version. Nothing waits for the device.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict

import numpy as np
import torch
from torch.func import functional_call

from .._device import place, resolve
from ..kernels import _build
from ..losses.dwa import dwa_combine
from ..losses.fusion_losses import fusion_loss_l1_grad, fusion_loss_mse_ssim
from ..losses.seg_loss import cross_entropy
from ..ops.color import rgb_to_ycrcb, ycrcb_to_rgb
from ..ops.image import resize_bilinear
from ..parallel.tensor import broadcast_whole
from ..utils.profiler import span
from .state import FusionTrainState, SegTrainState


def ce_share(logits: torch.Tensor, label: torch.Tensor, ignore_index: int,
             shard) -> torch.Tensor:
    """The cross-entropy this rank's loss carries: the whole batch's mean
    without a shard; under one, the sum over this rank's valid pixels
    divided by the count over every rank's."""
    if shard is None:
        return cross_entropy(logits, label, ignore_index)
    count = (label != ignore_index).sum().to(logits.dtype)
    return cross_entropy(logits, label, ignore_index,
                         count=shard.comm.all_reduce_sum_(count))


def _sum_over_ranks(shard, grads, losses):
    """Gradients and losses summed over the ranks, two all-reduces of
    flat buffers; unchanged without a shard."""
    if shard is None:
        return grads, losses
    flat = torch.cat([g.reshape(-1) for g in grads])
    shard.comm.all_reduce_sum_(flat)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    summed = shard.comm.all_reduce_sum_(torch.stack(losses))
    return out, list(summed)


def fold_seed(*ints: int) -> int:
    """A 63-bit generator seed from a tuple of non-negative ints (numpy's
    ``SeedSequence``): the port's counterpart of folding into a JAX key."""
    a, b = np.random.SeedSequence(list(ints)).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def make_fusion_train_step(model, tx, round1: bool, ignore_index: int = 255,
                           seg_scale: float = 0.8,
                           dwa_temperature: float = 1000.0,
                           dwa_warmup_steps: int = 10, grad_accum: int = 1,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           device=None) -> Callable:
    """model: ``JointPipeline``; tx: ``optimizer.AdamW`` (anything with
    ``update(grads, opt_state, params) -> opt_state``). Returns
    ``step(state, batch, fusion_scale, shard=None) -> metrics``.

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
    in the reference). shard: under data parallelism this rank's
    ``BatchShard`` of the global batch, whose rows ``batch`` holds.
    metrics: {'loss', 'loss_fusion', 'loss_seg', 'weights'}, device
    tensors (the global batch's under a shard).

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
                fusion_scale, shard):
        with torch.no_grad():
            tap1, tap2 = seg.encode_taps_raw(mb["guide"])
        vis_ycrcb = rgb_to_ycrcb(mb["vis"])
        guide_y = rgb_to_ycrcb(mb["guide"])[..., 0:1]
        weights = {n: p.to(compute_dtype) for n, p in state.params.items()}
        fused_y = functional_call(fusion, weights, (
            mb["ir"], vis_ycrcb[..., 0:1], tap1, tap2)).to(acc)
        share = 1.0 if shard is None else shard.share
        if round1:
            loss = fusion_loss_l1_grad(mb["ir"], vis_ycrcb, fused_y,
                                       guide_y) * share
            return (loss, loss, torch.zeros((), dtype=loss.dtype,
                                            device=dev),
                    torch.ones(2, device=dev))
        loss1 = fusion_loss_mse_ssim(mb["ir"], vis_ycrcb, fused_y,
                                     guide_y) * share
        # the unclipped RGB recombination, as the reference feeds its seg
        # loss (train.py:363-368)
        fused_rgb = ycrcb_to_rgb(torch.cat([fused_y, vis_ycrcb[..., 1:]],
                                           dim=-1))
        logits = resize_bilinear(seg(fused_rgb).to(acc),
                                 mb["label"].shape[1:3])
        loss2 = ce_share(logits, mb["label"], ignore_index, shard)
        total, _, w = dwa_combine(state.dwa, loss1, loss2, fusion_scale,
                                  seg_scale, dwa_temperature,
                                  dwa_warmup_steps)
        return total, loss1, loss2, w

    def grads_of(state, mb, fusion_scale, shard=None):
        with span("step/forward"):
            total, loss1, loss2, w = loss_fn(state, mb, fusion_scale, shard)
        with span("step/backward"):
            grads = torch.autograd.grad(total, list(state.params.values()))
        return grads, [t.detach() for t in (total, loss1, loss2, w)]

    def step(state: FusionTrainState, batch: Dict[str, torch.Tensor],
             fusion_scale, shard=None) -> Dict[str, torch.Tensor]:
        if state.step.device.type != dev.type:
            raise ValueError(f"the state is on {state.step.device}, the step "
                             f"on {dev}: create the state after "
                             "make_fusion_train_step")
        if shard is not None and grad_accum > 1:
            raise ValueError("grad_accum > 1 under data parallelism: use "
                             "data parallelism OR accumulation")
        with span("step"):
            batch = {k: v.to(dev) for k, v in batch.items()}
            if grad_accum > 1:
                gsum = sums = None
                for a in range(grad_accum):
                    g, ls = grads_of(state, {k: v[a] for k, v in
                                             batch.items()}, fusion_scale)
                    if gsum is None:
                        gsum, sums, w = list(g), ls[:3], ls[3]
                    else:
                        gsum = [x + y for x, y in zip(gsum, g)]
                        sums = [x + y for x, y in zip(sums, ls[:3])]
                inv = 1.0 / grad_accum
                grads = [g * inv for g in gsum]
                total, loss1, loss2 = (s * inv for s in sums)
            else:
                grads, (total, loss1, loss2, w) = grads_of(
                    state, batch, fusion_scale, shard)
            with span("step/allreduce"):
                if grad_accum == 1:
                    grads, (total, loss1, loss2) = _sum_over_ranks(
                        shard, grads, [total, loss1, loss2])
                grads = broadcast_whole(dict(zip(state.params, grads)),
                                        state.splits)
            with span("step/optimizer"):
                state.opt_state = tx.update(grads, state.opt_state,
                                            state.params)
            _, state.dwa, _ = dwa_combine(state.dwa, loss1, loss2,
                                          fusion_scale, seg_scale,
                                          dwa_temperature, dwa_warmup_steps)
            state.step = state.step + 1
            return {"loss": total, "loss_fusion": loss1, "loss_seg": loss2,
                    "weights": w}

    step.seg = seg      # the frozen copy this step reads
    return step


def make_seg_train_step(model, tx, ignore_index: int = 255,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        device=None) -> Callable:
    """model: ``SegmentationNetwork``; tx: ``optimizer.AdamW`` (the
    3-group ``adamw_poly_grouped`` in the driver). Returns
    ``step(state, batch, seed, shard=None) -> metrics``.

    The model moves to the device in f32 (f64 for an f64 compute dtype)
    and is trained in place, its BatchNorm buffers included; build the
    state after this call (``SegTrainState.create(model, tx)``).

    batch: {'image': [B,H,W,3] in [0,1], 'label': [B,H,W] int}. seed: the
    phase's base seed; step s draws its drop-path and dropout masks from
    ``fold_seed(seed, s)``. shard: under data parallelism this rank's
    ``BatchShard`` of the global batch, whose rows ``batch`` holds.
    metrics: {'loss'}, a device tensor (the global batch's under a
    shard).

    A parameter that takes no gradient (the aux ``classifier``, which the
    loss does not reach) gets a zero one, so the optimizer still decays it,
    as optax's AdamW does in the JAX step.

    ``device=None`` means ``cuda`` (raises when there is none);
    ``device="cpu"`` trains through the kernels' plain versions."""
    dev = resolve(device)
    acc = _build.acc_dtype(compute_dtype)
    seg = place(model, dev).to(acc)
    gen = torch.Generator(device=dev)

    def step(state: SegTrainState, batch: Dict[str, torch.Tensor],
             seed: int, shard=None) -> Dict[str, torch.Tensor]:
        if state.step.device.type != dev.type:
            raise ValueError(f"the state is on {state.step.device}, the step "
                             f"on {dev}: create the state after "
                             "make_seg_train_step")
        gen.manual_seed(fold_seed(seed, state.host_step))
        image, label = batch["image"].to(dev), batch["label"].to(dev)
        weights = {n: p.to(compute_dtype) for n, p in state.params.items()}
        draws = gen if shard is None else shard.with_gen(gen)
        logits = functional_call(seg, weights, (image,),
                                 {"train": True, "gen": draws})
        logits = resize_bilinear(logits.to(acc), label.shape[1:3])
        loss = ce_share(logits, label, ignore_index, shard)
        params = list(state.params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        grads, (loss,) = _sum_over_ranks(shard, grads, [loss.detach()])
        grads = broadcast_whole(dict(zip(state.params, grads)),
                                state.splits)
        state.opt_state = tx.update(grads, state.opt_state, state.params)
        state.step = state.step + 1
        state.host_step += 1
        return {"loss": loss.detach()}

    return step


def make_fuse_fn(model, compute_dtype: torch.dtype = torch.bfloat16,
                 device=None) -> Callable:
    """``fuse(ir [B,H,W,1], vis [B,H,W,3], guide [B,H,W,3]) -> (fused_rgb
    clipped to [0,1], fused_y)``, all in [0,1]: the regeneration pass of
    the driver, with the guide's taps and the VIS frame's R plane (the
    reference's inference behaviour). It runs a copy of ``model`` (a
    ``JointPipeline``) made now, in ``compute_dtype`` and eval mode, under
    ``inference_mode``: the weights of this call, as the JAX ``fuse_fn``
    takes the variables of its call."""
    dev = resolve(device)
    acc = _build.acc_dtype(compute_dtype)   # the inputs' dtype
    infer = place(copy.deepcopy(model), dev).to(compute_dtype).eval()

    def fuse(ir, vis, guide):
        with torch.inference_mode():
            return infer.fuse(ir.to(dev, acc), vis.to(dev, acc),
                              guide_rgb=guide.to(dev, acc))

    return fuse


def make_segment_fn(model, compute_dtype: torch.dtype = torch.bfloat16,
                    device=None) -> Callable:
    """``segment(rgb01 [B,H,W,3]) -> [B,H,W] int32``: the argmax of the
    f32 logits resized to the image size, through a copy of ``model`` (a
    ``SegmentationNetwork``) made now, in ``compute_dtype`` and eval
    mode."""
    dev = resolve(device)
    acc = _build.acc_dtype(compute_dtype)
    infer = place(copy.deepcopy(model), dev).to(compute_dtype).eval()

    def segment(rgb01):
        with torch.inference_mode():
            logits = infer(rgb01.to(dev, acc)).to(acc)
            logits = resize_bilinear(logits, rgb01.shape[1:3])
            return logits.argmax(dim=-1).to(torch.int32)

    return segment
