"""AdamW with the poly-warmup schedule and the reference's parameter groups
(counterpart of ``segmif_tpu/train/optimizer.py``).

The schedule at step t (t = update count + ``start_step``):

    t < warmup_iter:  lr * (1 - (1 - t / warmup_iter) * (1 - warmup_ratio))
    t < max_iter:     lr * (1 - t / max_iter) ** power
    t >= max_iter:    frozen at the last poly value

The update is optax's ``adamw``, written out: bias-corrected moments, eps
outside the square root of the corrected second moment, decoupled weight
decay on every parameter (no mask), and the learning rate read at the
update count *before* this update. The count, the schedule and the
moments are device tensors, so an update never waits for the device.

Under tensor parallelism each split leaf is the rank's piece and its
moments are the piece's (AdamW is element-wise); the names, and so the
groups, are those of the whole leaves.

Parameter groups (``seg_param_labels``, by the port's state-dict names)
mirror the reference's WeTr.get_param_groups: "encoder" (non-norm encoder
params: lr, wd), "encoder_norm" (encoder norm scales and biases: lr, wd 0)
and "decoder" (decoder and classifier: lr x 10, wd).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, NamedTuple

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def poly_warmup_schedule(base_lr: float, warmup_iter: int, max_iter: int,
                         warmup_ratio: float = 1e-6, power: float = 1.0,
                         start_step: int = 0) -> Schedule:
    """The learning rate as a function of the update count (an integer
    tensor), in f32. ``start_step`` offsets the count (a resumed run's
    ``iter_curr``)."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        t = count + start_step
        warm = 1.0 - (1.0 - t / max(warmup_iter, 1)) * (1.0 - warmup_ratio)
        tp = t.clamp_max(max_iter - 1)
        poly = (1.0 - tp / max_iter) ** power
        return base_lr * torch.where(t < warmup_iter, warm, poly)

    return schedule


class AdamWState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor       # int32 scalar, updates taken


class AdamW:
    """AdamW over a dict of parameters, each in a group with its own
    schedule and weight decay. ``labels`` maps a parameter name to its
    group; without it every parameter is in the one group ``"all"``."""

    def __init__(self, schedules: Mapping[str, Schedule],
                 weight_decays: Mapping[str, float],
                 labels: Mapping[str, str] = None, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.schedules = dict(schedules)
        self.weight_decays = dict(weight_decays)
        self.labels = labels
        self.b1, self.b2 = betas
        self.eps = eps

    def group(self, name: str) -> str:
        return "all" if self.labels is None else self.labels[name]

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        dev = next(iter(params.values())).device
        return AdamWState(
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
            count=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor]) -> AdamWState:
        """Apply one update to ``params`` in place; returns the new state
        (the moments are updated in place too)."""
        count = state.count + 1
        bc1 = 1.0 - torch.pow(self.b1, count.float())
        bc2 = 1.0 - torch.pow(self.b2, count.float())
        lrs = {g: s(state.count) for g, s in self.schedules.items()}
        for name, p in params.items():
            g = grads[name]
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            group = self.group(name)
            u = u + self.weight_decays[group] * p
            p.sub_(lrs[group] * u)
        return state._replace(count=count)


def adamw_poly(base_lr: float, warmup_iter: int, max_iter: int,
               weight_decay: float = 0.01, betas=(0.9, 0.999),
               warmup_ratio: float = 1e-6, power: float = 1.0,
               start_step: int = 0) -> AdamW:
    """Single-group poly-warmup AdamW (the fusion phase's optimizer)."""
    return AdamW({"all": poly_warmup_schedule(
        base_lr, warmup_iter, max_iter, warmup_ratio, power, start_step)},
        {"all": weight_decay}, betas=betas)


def _is_norm_or_bias(keys) -> bool:
    if keys[-1] in ("bias", "b"):
        return True
    return any("norm" in k or k == "bn" for k in keys)


def seg_param_labels(names: Iterable[str]) -> Dict[str, str]:
    """The group of each parameter of a ``SegmentationNetwork``, by its
    state-dict name: "encoder", "encoder_norm" or "decoder"."""
    out = {}
    for name in names:
        keys = name.lower().split(".")
        if any("encoder" in k for k in keys):
            out[name] = ("encoder_norm" if _is_norm_or_bias(keys)
                         else "encoder")
        else:
            out[name] = "decoder"
    return out


def adamw_poly_grouped(names: Iterable[str], base_lr: float,
                       warmup_iter: int, max_iter: int,
                       weight_decay: float = 0.01, betas=(0.9, 0.999),
                       warmup_ratio: float = 1e-6, power: float = 1.0,
                       start_step: int = 0,
                       decoder_lr_mult: float = 10.0) -> AdamW:
    """3-group poly-warmup AdamW for the segmentation phase, over the
    parameters named ``names`` (``seg_param_labels``)."""

    def sched(mult):
        return poly_warmup_schedule(base_lr * mult, warmup_iter, max_iter,
                                    warmup_ratio, power, start_step)

    return AdamW({"encoder": sched(1.0), "encoder_norm": sched(1.0),
                  "decoder": sched(decoder_lr_mult)},
                 {"encoder": weight_decay, "encoder_norm": 0.0,
                  "decoder": weight_decay},
                 labels=seg_param_labels(names), betas=betas)
