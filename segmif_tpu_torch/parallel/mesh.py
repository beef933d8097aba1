"""Data and tensor parallelism over ranks (counterpart of
``segmif_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ('data', 'model') mesh and
shards with ``jax.sharding``; here rank r of D x M ranks sits at (d, m) =
(r // M, r % M), the row-major reshape of the JAX ``make_mesh``:

 - ``make_mesh(data, model)``: ``data=-1`` means every rank over
   ``model`` (the JAX rule), 1 without a process group. The ranks of one
   d form a model group (``Mesh.model_comm``), those of one m a data group
   (``Mesh.comm``); both come from ``Comm.subgroup``.
 - ``batch_shard(mesh, B)`` says which rows a rank owns (the counterpart
   of ``batch_sharding`` / ``replicated``): data index d of D takes rows
   [d B/D, (d+1) B/D), and the M ranks of a model group hold the same rows
   and make the same draws. Where D does not divide B, the JAX package's
   replicated fallback (``put_batch``, mesh.py:95-106) applies: every rank
   takes the whole batch, which again gives what one device gives.
 - ``put_batch``: the rank's rows of a batch; ``put_replicated``: the
   parameters and buffers of a module broadcast from rank 0 of every
   rank.
 - ``tp_spec_for`` / ``param_shardings``: the Megatron split of the JAX
   package (``_tp_spec_for``, ``param_shardings``) by leaf name over
   rank-2 Dense kernels, the q / kv / fc1 / FFM projections by column and
   proj / fc2 / the FFM end projections by row, a leaf whose dimension
   ``model`` does not divide kept whole. The rule reads each leaf's JAX
   path (``convert.jax_path``: the converter's name map, so the decode
   head's ``linear_c{i}.proj`` is JAX's ``linear_c{i}`` and stays whole,
   and the FFM's ``kv3`` is JAX's ``kv_seg`` and is split) and answers in
   the port's layout: a ``Linear.weight`` is [out, in], so JAX's column
   split is dim 0 here and its row split dim 1. ``parallel.tensor`` holds
   the split model.

A ``BatchShard`` is what the train steps take under data parallelism
(``train.steps``): the rows, the share of the global pixel means that this
rank's loss carries (``share``: its rows over the rows of all ranks; 1/D
when every rank holds the whole batch), the sums over the data group
(``sum``, through autograd) and, once ``with_gen`` has given it a
generator, the random draws of the GLOBAL batch cut to its rows (``rand``),
so that a fixed seed gives the same masks for any D and M.

Not ported: ``put_batch_chunk`` serves only the chunked train loop, which
the port does not run (ROADMAP's "Do not port").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..convert import jax_path
from .dist import Comm

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` ranks. ``comm``: this rank's data group (every
    rank when ``model`` is 1; None for one rank without a process group);
    ``model_comm``: its model group (None when ``model`` is 1); ``world``:
    every rank (``comm`` when ``model`` is 1)."""
    data: int
    comm: Optional[Comm] = None
    model: int = 1
    model_comm: Optional[Comm] = None
    world: Optional[Comm] = None

    @property
    def everyone(self) -> Optional[Comm]:
        """Every rank's ``Comm`` (None for one rank)."""
        return self.comm if self.world is None else self.world

    @property
    def rank(self) -> int:
        """The rank among every rank (rank 0 writes the files)."""
        c = self.everyone
        return 0 if c is None else c.rank

    @property
    def data_rank(self) -> int:
        return self.rank // self.model


def _launch_hint(n: int) -> str:
    return (f"launch {n} ranks: torchrun --nproc_per_node {n}, or the "
            "CLI's own spawn")


def make_mesh(data: int = -1, model: int = 1, comm: Optional[Comm] = None,
              device=None) -> Mesh:
    """The ``data`` x ``model`` mesh over the ranks of ``comm`` (default:
    the default process group, whose tensors live on ``device``, the CPU
    unless given). ``data`` -1 means every rank over ``model``; data x
    model must be the number of ranks. With both axes above 1 ``comm``
    must be the default group: every rank of it makes the groups."""
    if comm is None and dist.is_available() and dist.is_initialized():
        comm = Comm("cpu" if device is None else device)
    world = 1 if comm is None else comm.world
    if model < 1:
        raise ValueError(f"mesh_model {model}: at least 1")
    if data == -1:
        if world % model:
            raise ValueError(f"mesh_model {model} does not divide the "
                             f"{world} ranks ({_launch_hint(model)})")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh_data {data} x mesh_model {model}: the "
                         f"mesh spans every rank, and there are {world} "
                         f"({_launch_hint(data * model)})")
    if model == 1:
        return Mesh(data, comm)
    if data == 1:
        return Mesh(1, None, model, comm, comm)
    if comm.group is not None:
        raise ValueError("a data x model mesh is made over the default "
                         "process group")
    models = [comm.subgroup([d * model + m for m in range(model)])
              for d in range(data)]
    datas = [comm.subgroup([d * model + m for d in range(data)])
             for m in range(model)]
    r = comm.rank
    return Mesh(data, datas[r % model], model, models[r // model], comm)


def tp_spec_for(path_keys: Sequence[str], shape) -> Tuple:
    """The JAX package's ``_tp_spec_for`` (segmif_tpu/parallel/mesh.py:
    47-75), on a leaf's JAX path and JAX shape: a PartitionSpec as a
    tuple, ``MODEL_AXIS`` on the split axis, () for a replicated leaf."""
    joined = "/".join(path_keys)
    # rank-2 (Dense) kernels only: the patch-embed 'proj' convs share a
    # module name with the attention's output projection
    if not joined.endswith("kernel") or len(shape) != 2:
        return ()
    name = path_keys[-2] if len(path_keys) >= 2 else ""
    col_split = name in ("q", "kv", "fc1", "channel_proj1", "channel_proj2",
                         "channel_proj3", "kv_seg", "kv1", "kv2")
    row_split = name in ("proj", "fc2", "end_proj1", "end_proj2")
    if col_split:
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    if row_split:
        return (None,) * (len(shape) - 2) + (MODEL_AXIS, None)
    return ()


def _jax_shape(shape) -> tuple:
    """A port leaf's shape in the JAX layout: Linear [out, in] -> Dense
    [in, out]; conv OIHW -> HWIO; others as they are."""
    shape = tuple(shape)
    if len(shape) == 2:
        return shape[::-1]
    if len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return shape


def param_shardings(model: int, params: Mapping[str, Any],
                    prefix: str = "") -> Dict[str, Optional[int]]:
    """The JAX package's ``param_shardings`` over ``model`` ranks, for the
    port's parameters ``params`` ({state-dict name under ``prefix``:
    tensor}): {name: the torch dim split over the model group, or None}.
    A leaf is split only where ``model`` divides the dimension."""
    out: Dict[str, Optional[int]] = {}
    for name, t in params.items():
        out[name] = None
        if model <= 1:
            continue
        jshape = _jax_shape(t.shape)
        spec = tp_spec_for(jax_path(prefix + name), jshape)
        for axis, ax in enumerate(spec):
            if ax is None:
                continue
            if jshape[axis] % model == 0:
                # JAX axis -1 (out) is torch dim 0, axis -2 (in) dim 1
                out[name] = len(jshape) - 1 - axis
    return out


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """Rows [lo, hi) of a global batch of ``total`` rows on this rank;
    ``share`` is the weight of this rank's batch means in the global one."""
    lo: int
    hi: int
    total: int
    share: float
    comm: Comm
    gen: Optional[torch.Generator] = None

    def take(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """Each entry's rows [lo, hi) (tensors or numpy arrays)."""
        return {k: v[self.lo:self.hi] for k, v in tree.items()}

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, through autograd."""
        return self.comm.all_reduce_sum(t)

    def with_gen(self, gen: torch.Generator) -> "BatchShard":
        return dataclasses.replace(self, gen=gen)

    def rand(self, shape, device) -> torch.Tensor:
        """Uniform draws from ``gen`` for the global batch (``shape`` with
        its leading dim set to ``total``), cut to this rank's rows."""
        u = torch.rand((self.total,) + tuple(shape[1:]), generator=self.gen,
                       device=device)
        return u[self.lo:self.hi]


def batch_shard(mesh: Mesh, batch_size: int) -> BatchShard:
    """The rows of a ``batch_size`` batch that this rank owns."""
    n, r = mesh.data, mesh.data_rank
    if batch_size % n:
        return BatchShard(0, batch_size, batch_size, 1.0 / n, mesh.comm)
    per = batch_size // n
    return BatchShard(r * per, (r + 1) * per, batch_size, per / batch_size,
                      mesh.comm)


def put_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of ``batch`` (every entry [B, ...])."""
    b = next(iter(batch.values())).shape[0]
    return batch_shard(mesh, b).take(batch)


@torch.no_grad()
def put_replicated(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """``module``'s parameters and buffers replaced by those of rank 0 of
    every rank, in place: one broadcast per dtype of a flat buffer on the
    ranks' device (NCCL moves no CPU tensor), wherever the module lives.
    Before ``parallel.tensor.tensor_parallel``: the split leaves are cut
    from the same whole ones on every rank."""
    comm = mesh.everyone
    if comm is None:
        return module
    tensors = list(module.parameters()) + list(module.buffers())
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t.data for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group]).to(comm.device)
        comm.broadcast_(flat)
        i = 0
        for t in group:
            t.copy_(flat[i:i + t.numel()].view(t.shape))
            i += t.numel()
    return module
