"""The plain reference of SegMiF's fusion-phase training step, rounds >= 2
(arXiv 2308.02097, Sec. 3.3; the reference code's train_fusion):

    fused Y = fusion(IR, VIS Y, taps of the guide by the frozen MiT)
    loss_fusion = MSE(fused Y, guide Y) + 1.1 (1 - SSIM(fused Y, guide Y))
    loss_seg    = cross-entropy of the frozen seg net on the fused image
                  (its Y and the VIS frame's chroma, unclipped), the labels'
                  ignore index left out, the mean over the counted pixels
    total       = w_f * loss_fusion * fusion_scale + w_s * loss_seg * seg_scale

with the dynamic weights (w_f, w_s) = 2 softmax((L[t-1] / L[t-2]) / T)
after a warm-up of 10 steps at (1, 1), and one AdamW update (optax's form:
bias-corrected moments, eps outside the square root, decoupled weight
decay, the learning rate at the update count before the update, linear
decay to ``max_iters``) of the fusion network's weights only. The seg
network is frozen: the gradient of the cross-entropy flows through it
into the fused image.

SSIM: the 11x11 Gaussian window (sigma 1.5), zero padding, C1 = 0.01^2,
C2 = 0.03^2, biased variances. The step runs over micro-batches of rows
and sums their gradients, which is exact: the frozen networks run in
eval mode, the pixel means have equal weight per row, and the
cross-entropy is summed over each micro-batch and divided by the whole
batch's count of counted pixels.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .model import FUS, Reference, resize, rgb_to_ycrcb, ycrcb_to_rgb

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def gaussian_window(size: int = 11, sigma: float = 1.5) -> List[float]:
    xs = [math.exp(-((i - size // 2) ** 2) / (2.0 * sigma ** 2))
          for i in range(size)]
    s = sum(xs)
    return [v / s for v in xs]


def ssim_map(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SSIM map of NHWC one-channel images, the window as one 2-D conv."""
    g = torch.tensor(gaussian_window(), dtype=a.dtype, device=a.device)
    win = (g[:, None] * g[None, :])[None, None]
    x, y = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)

    def blur(t):
        return F.conv2d(t, win, padding=5)

    mu1, mu2 = blur(x), blur(y)
    s11 = blur(x * x) - mu1 * mu1
    s22 = blur(y * y) - mu2 * mu2
    s12 = blur(x * y) - mu1 * mu2
    return ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / (
        (mu1 * mu1 + mu2 * mu2 + C1) * (s11 + s22 + C2))


def ce_sum(logits: torch.Tensor, label: torch.Tensor, ignore: int):
    """(sum of the negative log-likelihoods over the counted pixels, the
    count) of NHWC logits against [B, H, W] labels."""
    valid = label != ignore
    logp = torch.log_softmax(logits, dim=-1)
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), valid.sum()


class FusionTrainer:
    """``steps`` fusion-phase steps of configuration ``cfg`` from the state
    dict ``sd`` (float32, on one device); the fusion weights are copied and
    trained, the seg weights stay frozen. ``hp``: the traffic's
    hyperparameters (lr, max_iters, weight_decay, betas, eps,
    fusion_scale, seg_scale, dwa_temperature, dwa_warmup, ignore_index,
    ssim_weight)."""

    def __init__(self, cfg: Dict, sd: Dict[str, torch.Tensor], hp: Dict,
                 precision: str = "float32"):
        self.hp = hp
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in sd.items() if k.startswith(FUS)}
        frozen = {k: v for k, v in sd.items() if not k.startswith(FUS)}
        self.ref = Reference(cfg, {**frozen, **self.params}, precision)
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.prev = [1.0, 1.0]
        self.prev2 = [1.0, 1.0]
        self.dwa_step = 0

    def weights(self):
        hp = self.hp
        if self.dwa_step <= hp["dwa_warmup"]:
            return 1.0, 1.0
        w = [p / max(q, 1e-12) / hp["dwa_temperature"]
             for p, q in zip(self.prev, self.prev2)]
        e = [math.exp(x - max(w)) for x in w]
        return 2 * e[0] / sum(e), 2 * e[1] / sum(e)

    def grads(self, batch: Dict[str, torch.Tensor], micro: int):
        """(gradients by name, loss_fusion, loss_seg, total) of one batch,
        summed over micro-batches of ``micro`` rows."""
        hp, ref = self.hp, self.ref
        n = batch["ir"].shape[0]
        count = (batch["label"] != hp["ignore_index"]).sum().clamp_min(1)
        npix = batch["ir"][..., 0].numel()
        wf, ws = self.weights()
        names = list(self.params)
        total_g = [torch.zeros_like(self.params[k]) for k in names]
        loss1 = loss2 = 0.0
        for lo in range(0, n, micro):
            mb = {k: v[lo:lo + micro] for k, v in batch.items()}
            with ref.held():
                gs, part1, part2 = self._micro(mb, count, npix, wf, ws, names)
            for acc, g in zip(total_g, gs):
                acc += g
            loss1 += float(part1.detach())
            loss2 += float(part2.detach())
        total = wf * hp["fusion_scale"] * loss1 + ws * hp["seg_scale"] * loss2
        return dict(zip(names, total_g)), loss1, loss2, total

    def _micro(self, mb, count, npix, wf, ws, names):
        """One micro-batch's gradients and its shares of the two losses."""
        hp, ref = self.hp, self.ref
        with torch.no_grad():
            tap1, tap2 = ref.taps(mb["guide"])
        vis = rgb_to_ycrcb(mb["vis"])
        guide_y = rgb_to_ycrcb(mb["guide"])[..., 0:1]
        fused_y = ref.fusion(mb["ir"][..., 0:1], vis[..., 0:1], tap1, tap2)
        part1 = (((fused_y - guide_y) ** 2).sum()
                 + hp["ssim_weight"] * (1.0 - ssim_map(fused_y, guide_y)
                                        ).sum()) / npix
        fused_rgb = ycrcb_to_rgb(torch.cat([fused_y, vis[..., 1:]], -1))
        logits = resize(ref.seg_logits(fused_rgb),
                        mb["label"].shape[1:3])
        nll, _ = ce_sum(logits, mb["label"], hp["ignore_index"])
        part2 = nll / count
        obj = (wf * hp["fusion_scale"] * part1
               + ws * hp["seg_scale"] * part2)
        gs = torch.autograd.grad(obj, [self.params[k] for k in names])
        return gs, part1, part2

    @torch.no_grad()
    def adamw(self, grads: Dict[str, torch.Tensor]) -> None:
        hp = self.hp
        b1, b2 = hp["betas"]
        t = self.count + 1
        lr = hp["lr"] * (1.0 - min(self.count, hp["max_iters"] - 1)
                         / hp["max_iters"])
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (self.mu[k] / (1 - b1 ** t)) / (
                (self.nu[k] / (1 - b2 ** t)).sqrt() + hp["eps"])
            p.sub_(lr * (u + hp["weight_decay"] * p))
        self.count = t

    def step(self, batch: Dict[str, torch.Tensor], micro: int = 2):
        """One step; returns (gradients, loss_fusion, loss_seg, total)."""
        grads, l1, l2, total = self.grads(batch, micro)
        self.adamw(grads)
        self.prev2, self.prev = self.prev, [l1, l2]
        self.dwa_step += 1
        return grads, l1, l2, total


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tree.items()}


def reference_readings(cfg: Dict, sd: Dict[str, torch.Tensor], hp: Dict,
                       batches: Sequence[Dict[str, torch.Tensor]],
                       precision: str = "float32", micro: int = 2) -> Dict:
    """What the check compares, for ``len(batches)`` steps: each step's
    total loss and fusion loss, the first step's gradient norm per fusion
    leaf, each leaf's change in the first step, and the
    norm of each leaf's change over the steps. Leaf names are the fusion
    network's own (without ``fusion.``)."""
    tr = FusionTrainer(cfg, sd, hp, precision)
    start = {k: v.detach().clone() for k, v in tr.params.items()}
    losses, fusion_losses, grad_norms, first = [], [], None, None
    for i, batch in enumerate(batches):
        grads, loss_fusion, _, total = tr.step(batch, micro)
        losses.append(total)
        fusion_losses.append(loss_fusion)
        if i == 0:
            grad_norms = leaf_norms(grads)
            first = leaf_norms({k: tr.params[k] - start[k] for k in start})
    change = leaf_norms({k: tr.params[k] - start[k] for k in start})
    cut = len(FUS)
    return {"losses": losses, "fusion_losses": fusion_losses,
            "grad_norms": {k[cut:]: v for k, v in grad_norms.items()},
            "change_norms": {k[cut:]: v for k, v in change.items()},
            "first_change_norms": {k[cut:]: v for k, v in first.items()}}
