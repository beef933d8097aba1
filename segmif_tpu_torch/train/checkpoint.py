"""Checkpoints of the interactive trainer (counterpart of the roles of
``segmif_tpu/train/checkpoint.py``; ``torch.save`` in place of Orbax).

 - Role checkpoints (``fusion_params.pth``, ``seg_params.pth``): the
   fusion network's and the segmentation network's plain ``state_dict()``
   in the reference key layout (Fusion_Network3_ac; Network3's
   ``denoise_net.*``, BatchNorm running statistics included), on the CPU.
   The JAX package's ``load_torch_fusion_network`` and
   ``load_torch_seg_network`` read them unchanged.
 - Mid-phase checkpoints (``{role}_phase_r{N}.pth``): the whole train
   state (parameters, BatchNorm buffers, the AdamW moments and count, the
   step, the DWA buffer) and the best-mIoU gate, so that an interrupted
   phase resumes its exact trajectory.
 - ``load_pretrained_encoder``: an official MiT ImageNet checkpoint
   (``pretrained/<backbone>.pth``) into the encoder, ``head.*`` dropped.

Every file is written under a temporary name and renamed into place.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

import torch
import torch.nn as nn

from ..losses.dwa import DWAState


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def _save(obj, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str | Path):
    return torch.load(path, map_location="cpu", weights_only=True)


def save_role(path: str | Path, module: nn.Module) -> None:
    """``module.state_dict()`` on the CPU, in the reference key layout."""
    _save(_cpu(module.state_dict()), path)


@torch.no_grad()
def load_role(path: str | Path, module: nn.Module) -> None:
    """A role checkpoint into ``module`` (strict), on the module's
    device and in its dtypes."""
    module.load_state_dict(_load(path), strict=True)


def state_tree(state) -> dict:
    """A ``FusionTrainState`` or ``SegTrainState`` (AdamW's state) as a
    tree of CPU tensors."""
    opt = state.opt_state
    tree = {"params": _cpu(state.params),
            "opt": {"mu": _cpu(opt.mu), "nu": _cpu(opt.nu),
                    "count": opt.count.cpu()},
            "step": state.step.cpu()}
    if hasattr(state, "dwa"):
        tree["dwa"] = [t.cpu() for t in state.dwa]
    if hasattr(state, "batch_stats"):
        tree["batch_stats"] = _cpu(state.batch_stats)
        tree["host_step"] = state.host_step
    return tree


@torch.no_grad()
def load_state_tree(state, tree: dict) -> None:
    """``state_tree``'s output back into ``state``, in place (the
    parameters and buffers are the modules' own)."""
    dev = state.step.device
    for name in ("params", "batch_stats"):
        for k, t in getattr(state, name, {}).items():
            t.copy_(tree[name][k])
    opt = state.opt_state
    for name in ("mu", "nu"):
        for k, t in getattr(opt, name).items():
            t.copy_(tree["opt"][name][k])
    state.opt_state = opt._replace(count=tree["opt"]["count"].to(dev))
    state.step = tree["step"].to(dev)
    if hasattr(state, "dwa"):
        state.dwa = DWAState(*(t.to(dev) for t in tree["dwa"]))
    if hasattr(state, "batch_stats"):
        state.host_step = int(tree["host_step"])


def save_phase(path: str | Path, state, best_miou: float) -> None:
    _save({"state": state_tree(state), "best_miou": float(best_miou)}, path)


def load_phase(path: str | Path, state) -> float:
    """Restore ``state`` from a mid-phase checkpoint; returns its best
    mIoU."""
    tree = _load(path)
    load_state_tree(state, tree["state"])
    return float(tree["best_miou"])


@torch.no_grad()
def load_pretrained_encoder(encoder: nn.Module, path: str | Path) -> None:
    """An official mit_bN ImageNet checkpoint into ``encoder`` (a
    ``MixVisionTransformer``), dropping ``head.*`` as the reference does.
    Raises if any encoder weight is missing from the file."""
    sd = {k: v for k, v in _load(path).items() if not k.startswith("head.")}
    missing, _ = encoder.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"{path}: no weights for {sorted(missing)[:5]} "
                       f"(and {max(len(missing) - 5, 0)} more)")
