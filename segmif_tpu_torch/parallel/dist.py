"""The rank layer of the parallel paths. New in the port: ``jax.sharding``
has no counterpart to copy.

Ranks and backends:
 - ``init(world, rank, ...)`` joins a process group and returns the
   ``Comm`` of its ranks; ``env_ranks()`` reads torchrun's WORLD_SIZE,
   RANK, LOCAL_RANK and LOCAL_WORLD_SIZE.
 - The backend follows one rule (``choose_backend``): NCCL when the ranks
   run on CUDA and every rank of a host has a card of its own; gloo when
   ranks share a card or run on the CPU. NCCL refuses two ranks on one
   device ("Duplicate GPU detected"), and a host with one card runs all of
   its ranks on that card.
 - ``rank_device``: rank r of a host takes ``cuda:r % device_count``.
 - Hosts (``host_layout``): a host is a torchrun node, the port's
   counterpart of a JAX process. Of W ranks, L on each host
   (LOCAL_WORLD_SIZE), rank r sits on host h = r // L of P = W // L;
   where torchrun sets GROUP_RANK, h must equal it. Without a process
   group, or without LOCAL_WORLD_SIZE, there is one host.
 - ``launch(fn, world, ...)`` spawns ``world`` ranks (the ``spawn`` start
   method, a ``file://`` rendezvous in a fresh directory), runs
   ``fn(comm, *args)`` on each and returns their results in rank order. It
   kills every rank when one fails or the time runs out. With
   ``ranks_per_host`` L it emulates W / L hosts on one machine: each rank
   gets torchrun's LOCAL_RANK, LOCAL_WORLD_SIZE and GROUP_RANK for that
   layout, and keeps the device of one host's rank r (``rank_device``).
   The CLIs get their ranks through ``run_cli``: ``join_env`` under
   torchrun (``--nnodes P --node_rank h`` included), ``launch`` for
   ``--mesh_data N`` / ``--mesh_model M`` / ``--spatial N`` when they run
   alone.

Collectives (``Comm``): ``all_reduce_sum_`` (in place), ``all_reduce_sum``
(differentiable: its backward all-reduces the incoming gradient),
``broadcast_``, ``all_gather_rows``, ``all_gather`` and
``reduce_scatter`` (equal shards along a dim: tensor parallelism's) and
``exchange_rows`` (the halo's neighbour exchange). ``subgroup`` makes the
``Comm`` of some of the ranks (the data and model groups of a two-axis
mesh). Gloo moves CUDA tensors in all_reduce and broadcast only; for
send/recv and all_gather, ``Comm`` stages CUDA tensors through pinned host
buffers, and gloo's reduce-scatter is an all-reduce and a slice. It does
so explicitly, ``init`` says so in one log line, and ``Comm.transport``
names it. The compute stays on the card: this is a transport, not a
fallback.

Every init and every collective has a timeout (``TIMEOUT_S`` unless the
caller gives one), so no rank waits forever on a peer that died.
"""
from __future__ import annotations

import datetime
import logging
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TIMEOUT_S = 300.0

log = logging.getLogger("segmif_tpu_torch")


def env_ranks() -> Tuple[int, int, int, int]:
    """(world, rank, local rank, ranks on this host) from torchrun's
    environment; (1, 0, 0, 1) without it."""
    e = os.environ
    world = int(e.get("WORLD_SIZE", 1))
    rank = int(e.get("RANK", 0))
    return (world, rank, int(e.get("LOCAL_RANK", rank)),
            int(e.get("LOCAL_WORLD_SIZE", world)))


def host_layout() -> Tuple[int, int]:
    """(h, P): this rank's host and the number of hosts, from the default
    process group and torchrun's LOCAL_WORLD_SIZE (and GROUP_RANK, checked
    where set); (0, 1) without a process group or LOCAL_WORLD_SIZE.
    Raises ``ValueError`` for a layout of unequal hosts."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    world, rank = dist.get_world_size(), dist.get_rank()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host < 1 or world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"LOCAL_WORLD_SIZE={per_host}: every host runs as "
                         "many ranks")
    host = rank // per_host
    group = os.environ.get("GROUP_RANK")
    if group is not None and int(group) != host:
        raise ValueError(f"rank {rank} with {per_host} ranks a host sits on "
                         f"host {host}, but GROUP_RANK is {group}: torchrun "
                         "numbered its ranks by another layout")
    return host, world // per_host


def choose_backend(device_type: str, ranks_per_host: int) -> str:
    """"nccl" when the ranks run on CUDA and each of a host's
    ``ranks_per_host`` ranks has a card of its own, else "gloo"."""
    if device_type == "cuda" and \
            ranks_per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device of a host's ``local_rank``-th rank: ``cuda:local_rank %
    device_count`` on CUDA, the CPU otherwise."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device(device_type)


def init(world: int, rank: int, backend: Optional[str] = None,
         device: str = "cpu", init_method: str = "env://",
         timeout: float = TIMEOUT_S, local_rank: Optional[int] = None,
         ranks_per_host: Optional[int] = None) -> "Comm":
    """Join the default process group as ``rank`` of ``world`` and return
    its ``Comm``. ``device`` is the device type the ranks compute on; the
    rank takes ``rank_device(device, local_rank)`` (``local_rank``
    defaults to ``rank``: one host). ``backend`` defaults to
    ``choose_backend``'s rule. ``init_method``: "env://" (torchrun's
    MASTER_ADDR / MASTER_PORT), "file://<path>" or "tcp://host:port"."""
    dev = rank_device(torch.device(device).type,
                      rank if local_rank is None else local_rank)
    backend = backend or choose_backend(
        dev.type, world if ranks_per_host is None else ranks_per_host)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    comm = Comm(dev)
    if comm.staged:
        log.info("parallel: %s", comm.transport)
    return comm


def join_env(device: str = "cuda") -> "Comm":
    """Join torchrun's process group (``env_ranks``; the rendezvous from
    MASTER_ADDR / MASTER_PORT) with ranks computing on ``device``."""
    world, rank, local, per_host = env_ranks()
    comm = init(world, rank, device=device, local_rank=local,
                ranks_per_host=per_host)
    host_layout()   # raises here on a layout torchrun did not number so
    return comm


def leave() -> None:
    """Leave the default process group (``init`` / ``join_env``)."""
    dist.destroy_process_group()


def run_cli(ranks: int, device: str, run: Callable, spawned: Callable,
            argv: list):
    """How a CLI takes its ranks: under torchrun it joins the group and
    returns ``run(comm)``; alone with ``ranks`` > 1 it spawns them
    (``launch``), each running ``spawned(comm, argv)``, and returns rank
    0's result; else ``run(None)``."""
    if env_ranks()[0] > 1:
        comm = join_env(device)
        try:
            return run(comm)
        finally:
            leave()
    if ranks > 1:
        return launch(spawned, ranks, (argv,), device=device,
                      timeout=None)[0]
    return run(None)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradient over
    the ranks, since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, comm, t):
        ctx.comm = comm
        return comm.all_reduce_sum_(t.clone(
            memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.all_reduce_sum_(g.clone(
            memory_format=torch.contiguous_format))


class Comm:
    """The ranks of one process group (the default one unless ``group``)
    and the collectives the parallel paths use, on ``device``'s tensors.
    ``rank`` and ``world`` are within the group."""

    def __init__(self, device, group=None):
        self.device = torch.device(device)
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        # gloo moves no CUDA tensor in send/recv or all_gather
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.transport = (
            f"{self.backend} on {self.device.type}"
            + (": send/recv and all_gather staged through pinned host "
               "buffers; all_reduce and broadcast by gloo's CUDA support"
               if self.staged else ""))

    def __deepcopy__(self, memo):
        # a process group is not copied: a deep copy of a module that
        # holds a Comm (a tensor-parallel model) talks to the same ranks
        return self

    def global_rank(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def subgroup(self, ranks: Sequence[int]) -> Optional["Comm"]:
        """The ``Comm`` of ``ranks`` (global ranks) for its members, None
        for the others. Every rank of this group must call it, in the same
        order."""
        group = dist.new_group(list(ranks), timeout=datetime.timedelta(
            seconds=TIMEOUT_S))
        if dist.get_rank() not in ranks:
            return None
        return Comm(self.device, group)

    # ----------------------------------------------------------- collectives

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, through autograd."""
        return _AllReduceSum.apply(self, t)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` replaced by rank ``src``'s, in place."""
        dist.broadcast(t, self.global_rank(src), group=self.group)
        return t

    def barrier(self) -> None:
        """Wait for every rank, through a one-element all_reduce: a
        collective on the group's own device, bounded by its timeout."""
        self.all_reduce_sum_(torch.zeros(1, device=self.device))

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the transport moves it: a pinned host copy when
        staged, else ``t`` itself (contiguous)."""
        t = t.contiguous()
        if not self.staged:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)

    def _buffer(self, shape, dtype) -> torch.Tensor:
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def all_gather_rows(self, x: torch.Tensor, counts: Sequence[int],
                        dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``, in rank order;
        rank r's ``x`` has ``counts[r]`` entries along ``dim`` (the others
        equal on every rank)."""
        xm = x.movedim(dim, 0)
        m = max(counts)
        pad = xm.new_zeros((m,) + tuple(xm.shape[1:]))
        pad[:xm.shape[0]] = xm
        wire = self._wire(pad)
        outs = [self._buffer(wire.shape, wire.dtype)
                for _ in range(self.world)]
        dist.all_gather(outs, wire, group=self.group)
        out = torch.cat([o[:c] for o, c in zip(outs, counts)])
        return out.to(self.device).movedim(0, dim)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` (the same shape on every rank) concatenated
        along ``dim``, in rank order; contiguous."""
        wire = self._wire(x)
        outs = [self._buffer(wire.shape, wire.dtype)
                for _ in range(self.world)]
        dist.all_gather(outs, wire, group=self.group)
        return torch.cat(outs, dim=dim).to(self.device)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum of ``x`` over the ranks, cut into ``world`` equal
        pieces along ``dim``: this rank's piece. NCCL reduces and scatters
        in one call; gloo all-reduces (through its CUDA support, as
        ``all_reduce_sum_``) and slices. No path of the package calls it:
        the split model's gather slices in its backward, and only the
        planted fault that gives that backward a reduce-scatter uses it
        (chip_smoke.py phase 14, tests/parallel_ranks.py)."""
        n = x.shape[dim] // self.world
        if x.shape[dim] % self.world:
            raise ValueError(f"reduce_scatter: {x.shape[dim]} entries along "
                             f"dim {dim} over {self.world} ranks")
        if self.backend == "nccl":
            xm = x.movedim(dim, 0).contiguous()
            out = xm.new_empty((n,) + tuple(xm.shape[1:]))
            dist.reduce_scatter_tensor(out, xm, group=self.group)
            return out.movedim(0, dim)
        full = self.all_reduce_sum_(x.clone(
            memory_format=torch.contiguous_format))
        return full.narrow(dim, self.rank * n, n)

    def exchange_rows(self, top: torch.Tensor, bottom: torch.Tensor,
                      from_above: Optional[Tuple], from_below: Optional[Tuple]
                      ) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
        """The halo's neighbour exchange: ``top`` goes to rank - 1 and
        ``bottom`` to rank + 1 (none past either end); returns the
        tensors received from rank - 1 (shape ``from_above``) and from
        rank + 1 (shape ``from_below``), None where there is no such
        neighbour, on this rank's device. The sends and receives go out
        as one batch (``batch_isend_irecv``): NCCL needs a send and a
        receive with the same peer grouped, or both ranks of a pair wait
        on their receives."""
        ops, recv = [], [None, None]
        dt = top.dtype
        for side, (nb, send, shape) in enumerate((
                (self.rank - 1, top, from_above),
                (self.rank + 1, bottom, from_below))):
            if not 0 <= nb < self.world:
                continue
            peer = self.global_rank(nb)
            recv[side] = self._buffer(shape, dt)
            ops.append(dist.P2POp(dist.irecv, recv[side], peer, self.group))
            ops.append(dist.P2POp(dist.isend, self._wire(send), peer,
                                  self.group))
        for w in dist.batch_isend_irecv(ops) if ops else ():
            w.wait()
        return tuple(None if r is None else r.to(self.device)
                     for r in recv)


# ------------------------------------------------------------------ launch

def _rank_main(fn, rank, world, init_method, device, timeout, threads,
               args, results, per_host):
    """One spawned rank: take the host layout of ``per_host`` ranks a
    host, join the group, run ``fn``, report. A failure is reported before
    the group is left: leaving waits on the peers' collectives, and the
    parent kills every rank once it hears."""
    joined = False
    os.environ.update(LOCAL_WORLD_SIZE=str(per_host),
                      LOCAL_RANK=str(rank % per_host),
                      GROUP_RANK=str(rank // per_host))
    try:
        if threads:
            torch.set_num_threads(threads)
        comm = init(world, rank, None, device, init_method, timeout)
        joined = True
        value = fn(comm, *args)
        comm.barrier()
        report = (rank, True, value)
    except BaseException:   # reported to the parent, which re-raises
        report = (rank, False, traceback.format_exc())
    results.put(report)
    if joined:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, args: tuple = (), device: str = "cpu",
           timeout: Optional[float] = TIMEOUT_S,
           threads: Optional[int] = None,
           workdir: Optional[str] = None,
           ranks_per_host: Optional[int] = None) -> List:
    """Run ``fn(comm, *args)`` on ``world`` spawned ranks and return the
    ranks' results in rank order.

    ``fn`` is a module-level function (the ranks import it by its import
    path) and returns something picklable: numbers, strings, numpy
    arrays, not tensors. ``device``: the device type of the ranks
    (``rank_device`` places them; the backend follows
    ``choose_backend``'s rule for one host); ``threads`` sets each rank's
    intra-op threads (the host's cores shared out by default). The
    rendezvous file lives in a fresh directory under ``workdir`` (the
    system's temporary directory by default), removed after.
    ``ranks_per_host``: the ranks emulate ``world / ranks_per_host`` hosts
    (``host_layout``; one host by default); the devices and the backend
    stay those of one host's ``world`` ranks. Raises
    ``RuntimeError`` with the failing rank's traceback, or
    ``TimeoutError`` after ``timeout`` seconds (None: no limit on the
    whole run; each collective still times out after ``TIMEOUT_S``);
    either way every rank is killed first."""
    import multiprocessing as mp

    from .._device import resolve

    resolve(device)   # raises here, not in every rank, without a card
    per_host = world if ranks_per_host is None else ranks_per_host
    if per_host < 1 or world % per_host:
        raise ValueError(f"launch: {world} ranks do not split into hosts of "
                         f"{per_host}")
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    pg_timeout = TIMEOUT_S if timeout is None else min(timeout, TIMEOUT_S)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="segmif_ranks_", dir=workdir)
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world, init_method, device, pg_timeout, threads, args,
        results, per_host)) for r in range(world)]
    out: List = [None] * world
    pending = set(range(world))
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        silent_dead = set()
        while pending:
            left = 1.0 if deadline is None else deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(pending)} of {world} gave "
                                   f"no result within {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                # a rank that died without a word fails the launch, once
                # a further poll has found nothing in the queue
                dead = {r for r in pending if not procs[r].is_alive()}
                if dead & silent_dead:
                    r = min(dead & silent_dead)
                    raise RuntimeError(f"rank {r} of {world} exited with "
                                       f"code {procs[r].exitcode} and no "
                                       "result")
                silent_dead = dead
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out
