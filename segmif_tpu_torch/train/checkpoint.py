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
Under tensor parallelism (``parallel.tensor``) the files hold what one
process holds: the split parameters and their AdamW moments are gathered
before a save (a collective: every rank takes part, one writes) and cut
to the rank's pieces on a load, for any number of ranks a model group.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

import torch
import torch.nn as nn

from ..losses.dwa import DWAState
from ..parallel.tensor import gather_state_dict, gather_tree, \
    shard_state_dict, shard_tree


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


def save_role(path: str | Path, module: nn.Module,
              state_dict: Dict[str, torch.Tensor] = None) -> None:
    """``module.state_dict()`` on the CPU, in the reference key layout
    (``state_dict``: that of ``parallel.tensor.gather_state_dict``, taken
    by every rank of a split module beforehand)."""
    if state_dict is None:
        state_dict = gather_state_dict(module)
    _save(_cpu(state_dict), path)


@torch.no_grad()
def load_role(path: str | Path, module: nn.Module) -> None:
    """A role checkpoint into ``module`` (strict), on the module's
    device and in its dtypes; a split module takes its pieces."""
    module.load_state_dict(shard_state_dict(module, _load(path)),
                           strict=True)


def state_tree(state) -> dict:
    """A ``FusionTrainState`` or ``SegTrainState`` (AdamW's state) as a
    tree of CPU tensors, the split leaves gathered (a collective under
    tensor parallelism)."""
    opt = state.opt_state
    splits = state.splits

    def whole(tensors):
        return _cpu(gather_tree(tensors, splits))

    tree = {"params": whole(state.params),
            "opt": {"mu": whole(opt.mu), "nu": whole(opt.nu),
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
    splits = state.splits
    for name in ("params", "batch_stats"):
        part = shard_tree(tree[name], splits) if name == "params" \
            else tree.get(name, {})
        for k, t in getattr(state, name, {}).items():
            t.copy_(part[k])
    opt = state.opt_state
    for name in ("mu", "nu"):
        part = shard_tree(tree["opt"][name], splits)
        for k, t in getattr(opt, name).items():
            t.copy_(part[k])
    state.opt_state = opt._replace(count=tree["opt"]["count"].to(dev))
    state.step = tree["step"].to(dev)
    if hasattr(state, "dwa"):
        state.dwa = DWAState(*(t.to(dev) for t in tree["dwa"]))
    if hasattr(state, "batch_stats"):
        state.host_step = int(tree["host_step"])


def save_phase(path: str | Path, state, best_miou: float,
               tree: dict = None) -> None:
    """The mid-phase checkpoint (``tree``: ``state_tree(state)``, taken
    by every rank of a split state beforehand)."""
    tree = state_tree(state) if tree is None else tree
    _save({"state": tree, "best_miou": float(best_miou)}, path)


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
