"""The plain reference of the seg phase's training step: SegFormer's
training recipe (Xie et al., NeurIPS 2021, arXiv 2105.15203, Sec. 4.1),
as SegMiF trains its segmentation network in every round's seg phase:

    x      = (255 image - ImageNet mean) / ImageNet std
    logits = head(MiT(x))          in training mode: stochastic depth on
                                   both branches of every MiT block, the
                                   head's BatchNorm on the batch's own
                                   statistics, dropout before the classifier
    loss   = cross-entropy of the logits bilinearly resized to the label's
             size (half-pixel centres), the ignore index left out, the
             mean over the counted pixels
    one AdamW update of every weight, over three parameter groups, the
    learning rate on a poly schedule

MiT and the head are ``model.Reference``'s (the same products, through
its ``precision``); this module adds their training mode. Stochastic
depth of block i of the whole encoder at rate r_i = r (i / (depth - 1)):
a branch's output times its sample's keep mask over 1 - r_i. Dropout:
kept elements over 1 - rate. BatchNorm: the batch's mean and biased
variance normalise; the running buffers take 0.9 of themselves and 0.1
of the batch's. AdamW: bias-corrected moments, eps outside the square
root, decoupled weight decay (p - lr (u + wd p), torch.optim.AdamW's
p (1 - lr wd) - lr u), the learning rate read at the update count before
the update; poly: lr (1 - t / max_iters) ** power, t the count plus the
schedule's start, after a linear warm-up from lr x warmup_ratio.

Departures from SegFormer's published training, each as the seg phase
under test computes it:
 - the running variance is folded biased (flax's form, which the port
   keeps); torch's SyncBN folds the unbiased one, n / (n - 1) larger at
   n = 8 x 256 x 256 values a channel. Only evaluation reads the buffers;
 - the parameter groups are SegMiF's (WeTr.get_param_groups): the
   encoder's norm scales and every encoder bias without weight decay, the
   decoder (head and the aux classifier) at 10 x the learning rate with
   decay. mmseg's SegFormer config exempts every norm (the head's
   BatchNorm too) and ``pos_block`` from decay, and multiplies the head's
   learning rate by 10;
 - SegMiF's aux classifier (a 1x1 conv on stage 4, no bias) is trained
   with the rest: no loss reaches it, so its update is its weight decay;
 - the drop-path and dropout masks are given (the masks the program drew
   in the same step), not drawn here, so that the comparison is of the
   maths and not of two generators.

Computed in blocks so that a step fits beside nothing else on one card:
each MiT block is checkpointed (its activations recomputed in the
backward pass), which changes no value. The head's BatchNorm takes the
whole batch's statistics, as the program's does.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .model import DEC, ENC, IMAGENET_MEAN, IMAGENET_STD, Reference, nchw, \
    nhwc, resize
from .train import ce_sum, leaf_norms

SEG = "seg."
BN = DEC + "linear_fuse.bn"
STATS = (BN + ".running_mean", BN + ".running_var")
BN_MOMENTUM = 0.9


def drop_path_rates(cfg: Dict, rate: float) -> List[float]:
    """The linear stochastic-depth schedule over every block, in order."""
    total = sum(cfg["depths"])
    return [rate * i / max(total - 1, 1) for i in range(total)]


def param_group(name: str) -> str:
    """SegMiF's group of a seg-network weight: ``encoder``,
    ``encoder_norm`` (an encoder norm's scale or bias, or an encoder
    bias) or ``decoder`` (everything else: the head, the classifier)."""
    keys = name.lower().split(".")
    if not any("encoder" in k for k in keys):
        return "decoder"
    if keys[-1] == "bias" or any("norm" in k or k == "bn" for k in keys):
        return "encoder_norm"
    return "encoder"


class SegTrainer:
    """Seg-phase steps of configuration ``cfg`` from the state dict ``sd``
    (float32, one device): every floating ``seg.`` weight is copied and
    trained, the head's BatchNorm buffers copied and updated. ``hp``: the
    traffic's hyperparameters (lr, decoder_lr_mult, weight_decay, betas,
    eps, power, max_iters, warmup_iters, warmup_ratio, start_step,
    drop_path, dropout, ignore_index). ``precision``: that of every
    product and, in the step, of every value (``precision.held_in``)."""

    def __init__(self, cfg: Dict, sd: Dict[str, torch.Tensor], hp: Dict,
                 precision: str = "float32"):
        self.cfg, self.hp = cfg, hp
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in sd.items()
                       if k.startswith(SEG) and v.is_floating_point()
                       and k not in STATS}
        self.stats = {k: sd[k].detach().clone() for k in STATS}
        self.ref = Reference(cfg, {**self.params, **self.stats}, precision)
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0

    # ------------------------------------------------------- the forward
    def block(self, t, name, h, w, heads, sr, rate, m1, m2):
        ref = self.ref
        y = ref.attention(ref.layer_norm(t, name + ".norm1", 1e-6),
                          name + ".attn", h, w, heads, sr)
        if rate > 0.0:
            y = y * m1 / (1.0 - rate)
        t = t + y
        y = ref.mix_ffn(ref.layer_norm(t, name + ".norm2", 1e-6),
                        name + ".mlp", h, w)
        if rate > 0.0:
            y = y * m2 / (1.0 - rate)
        return t + y

    def encoder(self, x: torch.Tensor, drop_masks: List[torch.Tensor]
                ) -> List[torch.Tensor]:
        """NHWC image -> the four stage maps, with stochastic depth; two
        of ``drop_masks`` taken a block whose rate is above 0."""
        cfg, ref, outs = self.cfg, self.ref, []
        rates = iter(drop_path_rates(cfg, self.hp["drop_path"]))
        masks = iter(drop_masks)
        for i in range(4):
            k = cfg["patch_sizes"][i]
            y = ref.conv(nchw(x), f"{ENC}patch_embed{i + 1}.proj",
                         stride=cfg["strides"][i], padding=k // 2)
            b, c, h, w = y.shape
            t = ref.layer_norm(nhwc(y).reshape(b, h * w, c),
                               f"{ENC}patch_embed{i + 1}.norm", 1e-5)
            for j in range(cfg["depths"][i]):
                rate = next(rates)
                m1, m2 = ((next(masks), next(masks)) if rate > 0.0
                          else (None, None))
                t = checkpoint(self.block, t, f"{ENC}block{i + 1}.{j}", h,
                               w, cfg["num_heads"][i], cfg["sr_ratios"][i],
                               rate, m1, m2, use_reentrant=False)
            t = ref.layer_norm(t, f"{ENC}norm{i + 1}", 1e-6)
            x = t.reshape(b, h, w, c)
            outs.append(x)
        if next(masks, None) is not None:
            raise ValueError("more drop-path masks than blocks that drop")
        return outs

    def head(self, feats: Sequence[torch.Tensor], drop: torch.Tensor
             ) -> torch.Tensor:
        """The decode head in training mode: logits at stage 1's
        resolution, NHWC. ``drop``: the dropout's keep mask, NCHW."""
        ref, size = self.ref, feats[0].shape[1:3]
        proj = []
        for i in (4, 3, 2, 1):
            p = ref.linear(feats[i - 1], f"{DEC}linear_c{i}.proj")
            if p.shape[1:3] != size:
                p = resize(p, size)
            proj.append(p)
        x = ref.conv(nchw(torch.cat(proj, dim=-1)), DEC + "linear_fuse.conv",
                     bias=False)
        with torch.no_grad():
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            for key, new in zip(STATS, (mean, var)):
                buf = self.stats[key]
                buf.copy_(BN_MOMENTUM * buf + (1.0 - BN_MOMENTUM) * new)
        x = F.batch_norm(x, None, None, ref.sd[BN + ".weight"],
                         ref.sd[BN + ".bias"], training=True, eps=1e-5)
        rate = self.hp["dropout"]
        x = torch.relu(x)
        if rate > 0.0:
            x = torch.where(drop, x / (1.0 - rate), torch.zeros_like(x))
        return nhwc(ref.conv(x, DEC + "linear_pred"))

    def loss(self, batch: Dict[str, torch.Tensor], masks: Dict):
        image = batch["image"]
        mean, std = image.new_tensor(IMAGENET_MEAN), image.new_tensor(
            IMAGENET_STD)
        feats = self.encoder((image * 255.0 - mean) / std,
                             [m.to(image) for m in masks["drop_path"]])
        drop = masks.get("dropout")
        logits = self.head(feats, None if drop is None
                           else drop.to(image.device))
        logits = resize(logits, batch["label"].shape[1:3])
        nll, count = ce_sum(logits, batch["label"], self.hp["ignore_index"])
        return nll / count.clamp_min(1)

    # ------------------------------------------------------ the update
    def lr(self, group: str) -> float:
        hp = self.hp
        base = hp["lr"] * (hp["decoder_lr_mult"] if group == "decoder"
                           else 1.0)
        t = self.count + hp["start_step"]
        if t < hp["warmup_iters"]:
            return base * (1.0 - (1.0 - t / hp["warmup_iters"])
                           * (1.0 - hp["warmup_ratio"]))
        t = min(t, hp["max_iters"] - 1)
        return base * (1.0 - t / hp["max_iters"]) ** hp["power"]

    @torch.no_grad()
    def adamw(self, grads: Dict[str, torch.Tensor]) -> None:
        hp = self.hp
        b1, b2 = hp["betas"]
        t = self.count + 1
        for k, p in self.params.items():
            g = grads[k]
            group = param_group(k)
            wd = 0.0 if group == "encoder_norm" else hp["weight_decay"]
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (self.mu[k] / (1 - b1 ** t)) / (
                (self.nu[k] / (1 - b2 ** t)).sqrt() + hp["eps"])
            p.sub_(self.lr(group) * (u + wd * p))
        self.count = t

    def step(self, batch: Dict[str, torch.Tensor], masks: Dict):
        """One step; returns (gradients by name, loss). ``masks``:
        {"drop_path": the step's block masks in order, "dropout": the
        head's keep mask}."""
        names = list(self.params)
        with self.ref.held():
            loss = self.loss(batch, masks)
            grads = torch.autograd.grad(
                loss, [self.params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(self.params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        self.adamw(grads)
        return grads, float(loss.detach())

    def host_stats(self) -> Dict[str, torch.Tensor]:
        return {k[len(SEG):]: v.detach().double().cpu()
                for k, v in self.stats.items()}


def keep_probabilities(cfg: Dict, hp: Dict) -> Dict:
    """The keep probability of each mask a step draws, by this module's
    schedule: two a block whose drop-path rate is above 0, in order, and
    the head's dropout (None at a rate of 0)."""
    rates = drop_path_rates(cfg, hp["drop_path"])
    return {"drop_path": [1.0 - r for r in rates if r > 0.0
                          for _ in range(2)],
            "dropout": 1.0 - hp["dropout"] if hp["dropout"] > 0.0 else None}


def seg_readings(cfg: Dict, sd: Dict[str, torch.Tensor], hp: Dict,
                 batches: Sequence[Dict[str, torch.Tensor]],
                 masks: Sequence[Dict], precision: str = "float32") -> Dict:
    """What the check compares, for ``len(batches)`` steps: each step's
    loss, the first step's gradient of every weight (``grads``, float32
    on the device), each weight's change in the first step and over the
    steps (norms), and the BatchNorm buffers before the steps, after the
    first and after the last (float64 on the host), and the masks' keep
    probabilities (``keep_probabilities``). Names are the seg network's
    own (without ``seg.``)."""
    tr = SegTrainer(cfg, sd, hp, precision)
    start = {k: v.detach().clone() for k, v in tr.params.items()}
    stats0 = tr.host_stats()
    losses, grads, first = [], None, None
    for i, (batch, m) in enumerate(zip(batches, masks)):
        g, loss = tr.step(batch, m)
        losses.append(loss)
        if i == 0:
            grads = {k: v.detach().float() for k, v in g.items()}
            first = leaf_norms({k: tr.params[k] - start[k] for k in start})
            stats = tr.host_stats()
        del g
    change = leaf_norms({k: tr.params[k] - start[k] for k in start})
    cut = len(SEG)
    return {"losses": losses,
            "grads": {k[cut:]: v for k, v in grads.items()},
            "first_change_norms": {k[cut:]: v for k, v in first.items()},
            "change_norms": {k[cut:]: v for k, v in change.items()},
            "stats0": stats0, "stats": stats,
            "stats_steps": tr.host_stats(),
            "keep": keep_probabilities(cfg, hp)}
