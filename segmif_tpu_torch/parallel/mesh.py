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
 - Several hosts (``dist.host_layout``: P torchrun nodes of L ranks;
   ``Mesh.host``, ``Mesh.hosts``): B stays the global batch, and host h
   reads its own B/P rows (the ``Prefetcher``'s stride, ``data.pipeline``),
   rows [h B/P, (h+1) B/P) of the global batch, which is the hosts'
   batches concatenated in host order. A rank's global rows [lo, hi) are
   as on one host; ``BatchShard.take`` reads them from its host's batch,
   at offset lo - h B/P. ``make_mesh`` refuses a model group that spans
   hosts (M must divide L: a model group's ranks read one batch), and
   ``batch_shard`` a batch whose host share B/P the host's data ranks do
   not divide (the replicated fallback has no meaning across hosts).
 - ``BatchShard.take``: the rank's rows of its host's batch (the JAX
   ``put_batch``'s part; the whole batch on one host);
   ``put_replicated``: the parameters and buffers of a module broadcast
   from rank 0 of every rank.
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
generator, the random draws of the GLOBAL batch cut to its rows (``rand``;
``own`` cuts any tree over the global batch), so that a fixed seed gives
the same masks for any D, M and P.

Not ported: ``put_batch_chunk`` serves only the chunked train loop, which
the port does not run (ROADMAP's "Do not port").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..convert import jax_path
from . import dist as _dist
from .dist import Comm

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` ranks. ``comm``: this rank's data group (every
    rank when ``model`` is 1; None for one rank without a process group);
    ``model_comm``: its model group (None when ``model`` is 1); ``world``:
    every rank (``comm`` when ``model`` is 1); ``host`` of ``hosts``: this
    rank's host (``dist.host_layout``)."""
    data: int
    comm: Optional[Comm] = None
    model: int = 1
    model_comm: Optional[Comm] = None
    world: Optional[Comm] = None
    host: int = 0
    hosts: int = 1

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

    @property
    def local_rank(self) -> int:
        """The rank among its host's ranks (0: the host's first)."""
        c = self.everyone
        return 0 if c is None else self.rank % (c.world // self.hosts)


def _launch_hint(n: int, hosts: int = 1) -> str:
    if hosts > 1:
        return (f"launch {n} ranks: torchrun --nnodes {hosts} "
                f"--nproc_per_node {n // hosts} on each of the {hosts} "
                "hosts")
    return (f"launch {n} ranks: torchrun --nproc_per_node {n}, or the "
            "CLI's own spawn")


def make_mesh(data: int = -1, model: int = 1, comm: Optional[Comm] = None,
              device=None) -> Mesh:
    """The ``data`` x ``model`` mesh over the ranks of ``comm`` (default:
    the default process group, whose tensors live on ``device``, the CPU
    unless given). ``data`` -1 means every rank over ``model``; data x
    model must be the number of ranks. With both axes above 1 ``comm``
    must be the default group: every rank of it makes the groups. Over the
    default group the mesh spans ``dist.host_layout``'s hosts, and a model
    group must lie within one (``ValueError`` otherwise); a mesh over a
    subgroup is one host's."""
    if comm is None and dist.is_available() and dist.is_initialized():
        comm = Comm("cpu" if device is None else device)
    world = 1 if comm is None else comm.world
    host, hosts = (0, 1) if comm is None or comm.group is not None \
        else _dist.host_layout()
    if model < 1:
        raise ValueError(f"mesh_model {model}: at least 1")
    if data == -1:
        if world % model:
            raise ValueError(f"mesh_model {model} does not divide the "
                             f"{world} ranks ({_launch_hint(model, hosts)})")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh_data {data} x mesh_model {model}: the "
                         f"mesh spans every rank, and there are {world} "
                         f"({_launch_hint(data * model, hosts)})")
    if (world // hosts) % model:
        raise ValueError(f"mesh_model {model} spans hosts: a model group's "
                         "ranks read one batch, so mesh_model must divide "
                         f"the {world // hosts} ranks of each of the {hosts} "
                         "hosts")
    at = {"host": host, "hosts": hosts}
    if model == 1:
        return Mesh(data, comm, **at)
    if data == 1:
        return Mesh(1, None, model, comm, comm, **at)
    if comm.group is not None:
        raise ValueError("a data x model mesh is made over the default "
                         "process group")
    models = [comm.subgroup([d * model + m for m in range(model)])
              for d in range(data)]
    datas = [comm.subgroup([d * model + m for d in range(data)])
             for m in range(model)]
    r = comm.rank
    return Mesh(data, datas[r % model], model, models[r // model], comm,
                **at)


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
    ``share`` is the weight of this rank's batch means in the global one;
    ``offset``: the global row at which this rank's host's batch starts."""
    lo: int
    hi: int
    total: int
    share: float
    comm: Comm
    gen: Optional[torch.Generator] = None
    offset: int = 0

    def take(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of its host's batch (tensors or numpy arrays;
        on one host the global batch): rows [lo, hi) less ``offset``."""
        return {k: v[self.lo - self.offset:self.hi - self.offset]
                for k, v in tree.items()}

    def own(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows [lo, hi) of a tree over the global batch
        (the augmentation's draws, a batch every rank holds whole)."""
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
    """The rows of a global ``batch_size`` batch that this rank owns.
    On several hosts ``ValueError`` unless the host's data ranks divide
    its share of the batch."""
    n, r, hosts = mesh.data, mesh.data_rank, mesh.hosts
    if batch_size % n and hosts > 1:
        raise ValueError(
            f"batch {batch_size} on {hosts} hosts: each host reads "
            f"{batch_size / hosts:g} rows, which its {n // hosts} data ranks "
            f"must divide (a batch size divisible by the {n} data ranks); "
            "one host's fallback, every rank holding the whole batch, has "
            "no meaning across hosts")
    if batch_size % n:
        return BatchShard(0, batch_size, batch_size, 1.0 / n, mesh.comm)
    per = batch_size // n
    return BatchShard(r * per, (r + 1) * per, batch_size, per / batch_size,
                      mesh.comm, offset=mesh.host * batch_size // hosts)


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
