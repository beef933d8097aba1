"""The seg-phase step's spans (``train.steps.make_seg_train_step``) on the
CPU, as ``test_torch_tracing.py`` reads the fusion step's: one step of
MiT-B0 at 32x32, batch 2, opens ``step`` once, and inside it
``step/forward``, ``step/backward`` and ``step/optimizer`` once each, in
that order, in a ``torch.profiler`` trace and in the host accounting;
``step/allreduce`` opens only under a shard (one gloo rank with a
``BatchShard`` of the whole batch), between the backward and the
optimizer.
"""
import pytest
import torch

from segmif_tpu_torch.models.network import SegmentationNetwork, init_params
from segmif_tpu_torch.parallel import dist
from segmif_tpu_torch.train.optimizer import adamw_poly_grouped
from segmif_tpu_torch.train.state import SegTrainState
from segmif_tpu_torch.train.steps import make_seg_train_step
from segmif_tpu_torch.utils import profiler
from segmif_tpu_torch.utils.profiler import span_totals, spans_on
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

BATCH = 2
STEP_SPANS = ["step/forward", "step/backward", "step/optimizer"]


def _step_once(shard=None, reader="profiler"):
    """One seg step; the step's spans it opened, [(name, parent name)] in
    the order they started (``profiler``), or {name: calls} (the host
    accounting)."""
    from torch.profiler import ProfilerActivity, profile

    model = init_params(SegmentationNetwork("mit_b0", 5),
                        torch.Generator().manual_seed(3))
    tx = adamw_poly_grouped([n for n, _ in model.named_parameters()], 6e-5,
                            0, 100)
    step = make_seg_train_step(model, tx, compute_dtype=torch.float32,
                               device="cpu")
    state = SegTrainState.create(model, tx)
    g = torch.Generator().manual_seed(4)
    batch = {"image": torch.rand(BATCH, 32, 32, 3, generator=g),
             "label": torch.randint(0, 5, (BATCH, 32, 32), generator=g)}
    if shard is not None:
        batch = shard.take(batch)
    if reader == "accounting":
        before = span_totals()
        with spans_on():
            step(state, batch, 11, shard)
        after = span_totals()
        return {n: c - before.get(n, (0, 0))[1] for n, (_, c) in
                after.items() if n.startswith("step")
                and c != before.get(n, (0, 0))[1]}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch, 11, shard)
    out = []
    for e in prof.events():
        name = e.name[len(profiler.PREFIX):]
        if not e.name.startswith(profiler.PREFIX) or not name.startswith(
                "step"):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(profiler.PREFIX):
            p = p.cpu_parent
        out.append((e.time_range.start, name,
                    None if p is None else p.name[len(profiler.PREFIX):]))
    return [(n, p) for _, n, p in sorted(out)]


def sharded_rank(comm, reader):
    """One gloo rank: the step under a shard of the whole batch."""
    from segmif_tpu_torch.parallel.mesh import batch_shard, make_mesh

    torch.set_num_threads(1)
    shard = batch_shard(make_mesh(-1, 1, comm, device="cpu"), BATCH)
    return _step_once(shard, reader)


@pytest.mark.parametrize("sharded", [False, True])
def test_seg_step_opens_its_spans_in_order(sharded):
    if sharded:
        got = dist.launch(sharded_rank, 1, ("profiler",), timeout=240,
                          threads=1)[0]
        inner = ["step/forward", "step/backward", "step/allreduce",
                 "step/optimizer"]
    else:
        got = _step_once()
        inner = STEP_SPANS
    assert got == [("step", None)] + [(n, "step") for n in inner], got


def test_seg_step_accounting_counts_each_span_once():
    assert _step_once(reader="accounting") == {
        n: 1 for n in ["step"] + STEP_SPANS}
