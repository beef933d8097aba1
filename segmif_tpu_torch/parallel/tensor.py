"""Tensor parallelism over a model group (counterpart of the TP half of
``segmif_tpu/parallel/mesh.py``, where GSPMD inserts the collectives that
this module writes out).

The split follows the JAX package's rule (``mesh.param_shardings``):
the MiT blocks' ``q``, ``kv`` and ``fc1`` kernels by column and ``proj``
and ``fc2`` by row, the FFM's ``channel_proj1-3``, ``kv_seg`` (``kv3``
here), ``kv1`` and ``kv2`` by column and ``end_proj1-2`` by row; biases,
norms, convs and the decode head stay whole, on every rank. In the port's
layout a column split cuts a ``Linear.weight`` [out, in] along dim 0 and a
row split along dim 1. ``tensor_parallel(pipeline, mesh)`` cuts the split
leaves in place (rank m of M keeps piece m) and marks the modules that run
them:

 - ``EfficientSelfAttention``: q and kv column-parallel (their input
   through ``copy``), proj row-parallel (``row_linear``: the partial
   products summed by ``reduce``, the bias added once, after the sum).
   The kv weight is [K; V]; rank m keeps the rows of its heads in K and
   in V (``kv_parts``: two parts), so its kv output is [k_m | v_m]. Where
   M divides the stage's heads each rank runs ``sr_attention`` on its
   H / M heads; where it does not, q, k and v are gathered (``gather``),
   every rank runs every head, and ``scatter`` hands proj the rank's
   columns. The sr conv and its LayerNorm run whole on every rank.
 - ``MixFFN``: fc1 column-parallel, fc2 row-parallel; the depthwise conv
   between them is whole and each rank applies its channels (the weight
   through ``copy``, so its gradient is summed over the group and every
   rank holds the full one).
 - the FFM's split leaves are gathered where they are used
   (``full_weight``, ``linear``): the grams need every column, so the FFM
   maths runs whole on every rank; the gather's backward slices.
 - a column-parallel bias is whole and each rank adds its slice of it
   (through ``copy`` as the depthwise conv's weight).

The four primitives, each a ``torch.autograd.Function`` over the model
group's ``Comm``:

    copy     forward: identity     backward: all-reduce
    reduce   forward: all-reduce   backward: identity
    gather   forward: all-gather   backward: the rank's slice
    scatter  forward: the slice    backward: all-gather

Every leaf that is whole gets the same gradient on every rank of the
group (bit for bit where the backward is deterministic; the train steps
broadcast them from the group's rank 0, ``broadcast_whole``); a split
leaf gets the gradient of its piece.
``split_leaves``, ``gather_state_dict`` / ``shard_state_dict`` and
``gather_tree`` / ``shard_tree`` move between a one-process state dict (a
checkpoint, the AdamW moments) and the rank's pieces. A ``Comm`` is not
copied by ``copy.deepcopy``, so a copy of a split model (a step's frozen
seg network, an inference copy) talks to the same ranks. A failed
collective raises.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from .dist import Comm
from .mesh import param_shardings

Split = Tuple[Comm, int, int]     # (model group, torch dim, parts)


# ------------------------------------------------------------ the pieces

def local(t: torch.Tensor, rank: int, world: int, dim: int,
          parts: int = 1) -> torch.Tensor:
    """Piece ``rank`` of ``world`` of ``t`` along ``dim``: ``t`` is read
    as ``parts`` equal parts, each cut into ``world`` pieces, and the
    rank's piece of each part is kept, in order."""
    n = t.shape[dim]
    if n % (parts * world):
        raise ValueError(f"tensor parallelism: {n} entries along dim {dim} "
                         f"in {parts} part(s) over {world} ranks")
    piece = n // (parts * world)
    tm = t.movedim(dim, 0)
    rest = tuple(tm.shape[1:])
    out = tm.reshape((parts, world, piece) + rest)[:, rank]
    return out.reshape((parts * piece,) + rest).movedim(0, dim)


def join(t: torch.Tensor, world: int, dim: int,
         parts: int = 1) -> torch.Tensor:
    """The inverse of ``local``: ``t`` holds the ranks' pieces
    concatenated along ``dim`` in rank order; returns the whole
    tensor."""
    tm = t.movedim(dim, 0)
    rest = tuple(tm.shape[1:])
    piece = tm.shape[0] // (parts * world)
    out = tm.reshape((world, parts, piece) + rest).transpose(0, 1)
    return out.reshape((world * parts * piece,) + rest).movedim(0, dim)


def _all_gather(t: torch.Tensor, comm: Comm, dim: int,
                parts: int) -> torch.Tensor:
    # contiguous: the kernels read gathered q, k, v with a unit last stride
    return join(comm.all_gather(t, dim), comm.world, dim,
                parts).contiguous()


# ------------------------------------------------------------ primitives

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce_sum_(g.clone(
            memory_format=torch.contiguous_format)), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce_sum_(x.clone(
            memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, parts):
        ctx.args = (comm, dim, parts)
        return _all_gather(x, comm, dim, parts)

    @staticmethod
    def backward(ctx, g):
        comm, dim, parts = ctx.args
        return local(g, comm.rank, comm.world, dim, parts), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, parts):
        ctx.args = (comm, dim, parts)
        return local(x, comm.rank, comm.world, dim, parts).contiguous()

    @staticmethod
    def backward(ctx, g):
        comm, dim, parts = ctx.args
        return _all_gather(g, comm, dim, parts), None, None, None


def copy(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Identity; the backward sums the gradient over the group."""
    return _Copy.apply(x, comm)


def reduce(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The sum over the group; the backward passes the gradient on."""
    return _Reduce.apply(x, comm)


def gather(x: torch.Tensor, comm: Comm, dim: int = -1,
           parts: int = 1) -> torch.Tensor:
    """The ranks' pieces along ``dim`` joined (``join``); the backward
    keeps the rank's piece of the gradient."""
    return _Gather.apply(x, comm, dim % x.ndim, parts)


def scatter(x: torch.Tensor, comm: Comm, dim: int = -1,
            parts: int = 1) -> torch.Tensor:
    """The rank's piece along ``dim`` (``local``); the backward gathers
    the gradient."""
    return _Scatter.apply(x, comm, dim % x.ndim, parts)


# ------------------------------------------------------------ linears

def _split(lin) -> Optional[Split]:
    """A split Linear's (model group, dim, parts); None when whole."""
    return getattr(lin, "tp_split", None)


def col_linear(x: torch.Tensor, lin, comm: Comm) -> torch.Tensor:
    """A column-parallel ``lin`` on the whole ``x``: the rank's output
    columns, its bias slice added."""
    bias = lin.bias
    if bias is not None:
        bias = local(copy(bias, comm), comm.rank, comm.world, 0,
                     lin.tp_split[2])
    return F.linear(copy(x, comm), lin.weight, bias)


def row_linear(x: torch.Tensor, lin, comm: Comm) -> torch.Tensor:
    """A row-parallel ``lin`` on the rank's input columns ``x``: the
    partial products summed over the group, then the bias, once."""
    y = reduce(F.linear(x, lin.weight), comm)
    return y if lin.bias is None else y + lin.bias


def full_weight(lin) -> torch.Tensor:
    """``lin.weight`` whole: gathered from the ranks' pieces when it is
    split."""
    split = _split(lin)
    if split is None:
        return lin.weight
    comm, dim, parts = split
    return gather(lin.weight, comm, dim, parts)


def linear(lin, x: torch.Tensor) -> torch.Tensor:
    """``lin(x)``, with a split weight gathered first."""
    if _split(lin) is None:
        return lin(x)
    return F.linear(x, full_weight(lin), lin.bias)


# ------------------------------------------------------------ the model

def kv_parts(name: str) -> int:
    """The parts a split leaf is read in (``local``): 2 for the MiT
    attention's kv ([K; V]: a rank keeps its heads of each), else 1."""
    return 2 if re.search(r"(^|\.)attn\.kv\.weight$", name) else 1


# the modules that run split leaves, and the torch dim of each
_PARALLEL = {"EfficientSelfAttention": {"q": 0, "kv": 0, "proj": 1},
             "MixFFN": {"fc1": 0, "fc2": 1}}


def tensor_parallel(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """``model`` (a ``JointPipeline``, the same on every rank: see
    ``mesh.put_replicated``) split over ``mesh``'s model group, in place;
    returns it. Nothing changes with one rank a group. Raises where the
    rule splits a leaf that no module here runs split, or splits some of
    a block's leaves and not the others."""
    if mesh.model == 1:
        return model
    comm = mesh.model_comm
    params = dict(model.named_parameters())
    dims = {k: d for k, d in param_shardings(comm.world, params).items()
            if d is not None}
    run = set()
    for name, mod in model.named_modules():
        want = _PARALLEL.get(type(mod).__name__)
        if want is None:
            continue
        got = {c: dims.get(f"{name}.{c}.weight") for c in want}
        if all(v is None for v in got.values()):
            continue
        if got != want:
            raise ValueError(f"tensor_parallel: {name} has split leaves "
                             f"{got}; its form runs {want} or none")
        mod.tp = comm
        run.update(f"{name}.{c}.weight" for c in want)
    stray = [k for k in dims if k not in run and ".ffm.cross." not in k]
    if stray:
        raise ValueError(f"tensor_parallel: the rule splits {stray}, which "
                         "no module runs split (the MiT blocks' q, kv, proj,"
                         " fc1, fc2 and the FFM's projections do)")
    with torch.no_grad():
        for key, dim in dims.items():
            lin = model.get_submodule(key.rsplit(".", 1)[0])
            parts = kv_parts(key)
            lin.weight.data = local(lin.weight.data, comm.rank, comm.world,
                                    dim, parts).contiguous()
            lin.tp_split = (comm, dim, parts)
    return model


def split_leaves(module: torch.nn.Module) -> Dict[str, Split]:
    """{parameter name: (model group, dim, parts)} of ``module``'s split
    leaves, in module order (empty for a whole module)."""
    out = {}
    for name, mod in module.named_modules():
        split = _split(mod)
        if split is not None:
            out[f"{name}.weight" if name else "weight"] = split
    return out


def gather_tree(tensors: Mapping[str, torch.Tensor],
                splits: Mapping[str, Split]) -> Dict[str, torch.Tensor]:
    """``tensors`` (named as the parameters: weights, gradients, AdamW
    moments) with each split one made whole; a collective of every rank
    of the groups."""
    out = dict(tensors)
    for key, (comm, dim, parts) in splits.items():
        with torch.no_grad():
            out[key] = _all_gather(tensors[key].detach(), comm, dim, parts)
    return out


def shard_tree(tensors: Mapping[str, torch.Tensor],
               splits: Mapping[str, Split]) -> Dict[str, torch.Tensor]:
    """The inverse of ``gather_tree``: each split entry cut to this
    rank's piece."""
    out = dict(tensors)
    for key, (comm, dim, parts) in splits.items():
        out[key] = local(tensors[key], comm.rank, comm.world, dim,
                         parts).contiguous()
    return out


def broadcast_whole(grads: Mapping[str, torch.Tensor],
                    splits: Mapping[str, Split]) -> Dict[str, torch.Tensor]:
    """``grads`` (named as the parameters) with every whole leaf's
    gradient replaced by that of rank 0 of the model group: one broadcast
    of a flat buffer; unchanged without split leaves. Every rank of the
    group computes the whole leaves' gradients from the same values, but
    on the card not bit for bit alike (cuDNN's weight gradients and the
    bilinear resize's backward sum with atomics), and the update must
    keep the whole leaves the same on every rank."""
    if not splits:
        return dict(grads)
    comm = next(iter(splits.values()))[0]
    whole = [k for k in grads if k not in splits]
    flat = torch.cat([grads[k].reshape(-1) for k in whole])
    comm.broadcast_(flat)
    out, i = dict(grads), 0
    for k in whole:
        out[k] = flat[i:i + grads[k].numel()].view_as(grads[k])
        i += grads[k].numel()
    return out


def gather_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` as one process holds it."""
    return gather_tree(module.state_dict(), split_leaves(module))


def shard_state_dict(module: torch.nn.Module,
                     sd: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A one-process state dict of ``module`` cut to this rank's
    pieces."""
    return shard_tree(sd, split_leaves(module))
