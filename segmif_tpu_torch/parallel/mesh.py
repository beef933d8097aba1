"""Data parallelism over ranks (counterpart of the DP half of
``segmif_tpu/parallel/mesh.py``).

The JAX package shards the batch axis of a ('data', 'model') mesh with
``jax.sharding``; here a rank owns rows of the global batch, by the same
rule:

 - ``make_mesh(data, model)``: ``data=-1`` means every rank of the
   process group (1 when there is none); ``model > 1`` raises (tensor
   parallelism is ROADMAP's "Tensor parallelism" item).
 - ``batch_shard(mesh, B)`` says which rows a rank owns (the
   counterpart of ``batch_sharding`` / ``replicated``): rank r of N takes
   rows [r B/N, (r+1) B/N). Where N does not divide B, the JAX package's
   replicated fallback (``put_batch``, mesh.py:95-106) applies: every rank
   takes the whole batch, which again gives what one device gives.
 - ``put_batch``: the rank's rows of a batch; ``put_replicated``: the
   parameters and buffers of a module broadcast from rank 0.

A ``BatchShard`` is what the train steps take under data parallelism
(``train.steps``): the rows, the share of the global pixel means that this
rank's loss carries (``share``: its rows over the rows of all ranks; 1/N
when every rank holds the whole batch), the ranks' sums (``sum``, through
autograd) and, once ``with_gen`` has given it a generator, the random
draws of the GLOBAL batch cut to its rows (``rand``), so that a fixed
seed gives the same masks for any N.

Not ported: ``put_batch_chunk`` serves only the chunked train loop, which
the port does not run (ROADMAP's "Do not port"); ``_tp_spec_for`` and
``param_shardings`` wait for the tensor-parallelism slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from .dist import Comm

TP_REFUSAL = ("mesh_model > 1: tensor parallelism is not ported; it is "
              "ROADMAP queue 1's \"Tensor parallelism\" item")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data axis of ``data`` ranks; ``comm`` is None for one rank
    without a process group."""
    data: int
    comm: Optional[Comm] = None

    @property
    def rank(self) -> int:
        return 0 if self.comm is None else self.comm.rank


def make_mesh(data: int = -1, model: int = 1, comm: Optional[Comm] = None,
              device=None) -> Mesh:
    """The data axis over the ranks of ``comm`` (default: the default
    process group, whose tensors live on ``device``, the CPU unless
    given). ``data`` is -1 or the number of ranks."""
    if model > 1:
        raise ValueError(TP_REFUSAL)
    if comm is None and dist.is_available() and dist.is_initialized():
        comm = Comm("cpu" if device is None else device)
    world = 1 if comm is None else comm.world
    data = world if data == -1 else data
    if data != world:
        raise ValueError(f"mesh_data {data}: the data axis spans every "
                         f"rank, and there are {world} (launch "
                         f"{data} ranks: torchrun --nproc_per_node {data}, "
                         "or the CLI's own spawn)")
    return Mesh(data, comm)


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
    n, r = mesh.data, mesh.rank
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
    """``module``'s parameters and buffers replaced by rank 0's, in
    place: one broadcast per dtype of a flat buffer on the ranks' device
    (NCCL moves no CPU tensor), wherever the module lives."""
    if mesh.comm is None:
        return module
    tensors = list(module.parameters()) + list(module.buffers())
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t.data for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group]).to(mesh.comm.device)
        mesh.comm.broadcast_(flat)
        i = 0
        for t in group:
            t.copy_(flat[i:i + t.numel()].view(t.shape))
            i += t.numel()
    return module
