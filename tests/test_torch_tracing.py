"""The port's spans (``segmif_tpu_torch.utils.profiler``) on the CPU: the
shared no-op when nothing reads them, the host accounting's totals, the
ranges a ``torch.profiler`` trace records and the parent each sits in (one
mit_b0 serving call and one round >= 2 fusion step at 32x32), the serving
export's graph with the spans on, the kernels' recompute backward (one
span per Function call) and the kernel library's build.
"""
import time

import numpy as np
import pytest
import torch

import export_cases
from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from segmif_tpu_torch import serving
from segmif_tpu_torch.kernels import _build
from segmif_tpu_torch.kernels.attention import (_sr_attention_grad,
                                                sr_attention_ref)
from segmif_tpu_torch.kernels.drdb import _drdb_grad, drdb_chain
from segmif_tpu_torch.kernels.ffm import (W_KEYS, _crosspath_grad,
                                          crosspath_folded_ref)
from segmif_tpu_torch.models.network import JointPipeline, init_params
from segmif_tpu_torch.train.optimizer import adamw_poly
from segmif_tpu_torch.train.state import FusionTrainState
from segmif_tpu_torch.train.steps import make_fusion_train_step
from segmif_tpu_torch.utils import profiler
from segmif_tpu_torch.utils.profiler import span, span_totals, spans_on

# span -> the span it opens in (None: outside any), for one serving call
SERVE_PARENTS = {
    "serve": {None},
    "seg/encoder": {"serve"},          # the guide's taps, then the seg pass
    "seg/stage1": {"seg/encoder"},
    "seg/stage2": {"seg/encoder"},
    "seg/stage3": {"seg/encoder"},
    "seg/stage4": {"seg/encoder"},
    "seg/head": {"serve"},
    "fusion": {"serve"},
    "fusion/drdb1": {"fusion"},
    "fusion/drdb2": {"fusion"},
    "fusion/drdb3": {"fusion"},
    "fusion/drdb4": {"fusion"},
    "fusion/ffm1": {"fusion"},
    "fusion/ffm2": {"fusion"},
}
# spans a serving call opens, with their counts (the encoder runs twice:
# stages 1-2 for the guide's taps, all four for the seg pass)
SERVE_CALLS = {name: 1 for name in SERVE_PARENTS} | {
    "seg/encoder": 2, "seg/stage1": 2, "seg/stage2": 2}
# and one fusion step of rounds >= 2
STEP_PARENTS = {
    "step": {None},
    "step/forward": {"step"},
    "step/backward": {"step"},
    "step/allreduce": {"step"},
    "step/optimizer": {"step"},
    "fusion": {"step/forward"},
    "fusion/drdb1": {"fusion"},
    "seg/encoder": {"step/forward"},
    "seg/stage4": {"seg/encoder"},
    "seg/head": {"step/forward"},
}


def _spans(prof):
    """{span name: {its parent span's name}} of a profiled block."""
    out = {}
    for e in prof.events():
        if not e.name.startswith(profiler.PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(profiler.PREFIX):
            p = p.cpu_parent
        out.setdefault(e.name[len(profiler.PREFIX):], set()).add(
            None if p is None else p.name[len(profiler.PREFIX):])
    return out


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def _calls(before, after):
    return {n: c - before.get(n, (0, 0))[1] for n, (_, c) in after.items()
            if c != before.get(n, (0, 0))[1]}


@pytest.fixture(scope="module")
def pipeline():
    model, ir, vis, _ = export_cases.setup()
    return model, ir, vis


@pytest.fixture(scope="module")
def serve_spans(pipeline):
    model, ir, vis = pipeline
    serve = serving.make_serving_fn(model, device="cpu")
    return _profiled(lambda: serve(ir, vis))


@pytest.fixture(scope="module")
def step_spans():
    torch.set_num_threads(1)
    model = init_params(JointPipeline("mit_b0"),
                        torch.Generator().manual_seed(3))
    tx = adamw_poly(1e-4, 0, 100)
    step = make_fusion_train_step(model, tx, round1=False,
                                  compute_dtype=torch.float32, device="cpu")
    state = FusionTrainState.create(model.fusion, tx)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, c))
                                 .astype(np.float32))
             for k, c in (("ir", 1), ("vis", 3), ("guide", 3))}
    batch["label"] = torch.from_numpy(rng.integers(0, 9, (1, 32, 32)))
    return _profiled(lambda: step(state, batch, 0.4))


def test_span_is_the_shared_noop_when_nothing_reads_it():
    assert not profiler._on
    a, b = span("serve"), span("fusion/drdb1")
    assert a is b is profiler._NOOP
    with a as entered:
        assert entered is a


def test_accounting_totals_nest_and_count_calls():
    before = span_totals()
    with spans_on():
        with span("test/outer"):
            for _ in range(2):
                with span("test/outer/inner"):
                    time.sleep(0.002)
        with spans_on():        # a nested block leaves it on
            pass
        assert profiler._on
    with span("test/outer/inner"):
        pass
    assert not profiler._on and span("test/outer") is profiler._NOOP
    after = span_totals()
    assert _calls(before, after) == {"test/outer": 1, "test/outer/inner": 2}
    spent = {n: after[n][0] - before.get(n, (0, 0))[0]
             for n in ("test/outer", "test/outer/inner")}
    assert spent["test/outer"] >= spent["test/outer/inner"] >= 4e6


def test_accounting_loses_no_call_across_threads():
    """More threads than cores close spans at once, with the interpreter
    switching threads as often as it can: every call is counted."""
    import sys
    import threading

    threads, calls = 16, 2000

    def work():
        for _ in range(calls):
            with span("test/threads"):
                pass

    before = span_totals()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans_on():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert _calls(before, span_totals()) == {"test/threads": threads * calls}


def test_accounting_counts_one_serving_call(pipeline):
    model, ir, vis = pipeline
    serve = serving.make_serving_fn(model, device="cpu")
    before = span_totals()
    with spans_on():
        serve(ir, vis)
    assert _calls(before, span_totals()) == SERVE_CALLS


@pytest.mark.parametrize("name", sorted(SERVE_PARENTS))
def test_serving_trace_holds_span_in_its_parent(serve_spans, name):
    assert serve_spans.get(name) == SERVE_PARENTS[name], serve_spans


@pytest.mark.parametrize("name", sorted(STEP_PARENTS))
def test_train_step_trace_holds_span_in_its_parent(step_spans, name):
    assert step_spans.get(name) == STEP_PARENTS[name], step_spans


@pytest.mark.parametrize("reader", ["accounting", "profiler"])
def test_export_graph_gains_no_profiler_node(pipeline, reader):
    """The serving export traced while the spans are read: no profiler
    node in the program, the same ``segmif::`` nodes."""
    from torch.profiler import ProfilerActivity, profile

    model = pipeline[0]
    on = spans_on() if reader == "accounting" else profile(
        activities=[ProfilerActivity.CPU])
    before = span_totals()
    with on:
        program = torch.export.load(_buffer(serving.export_serving_artifact(
            model, 1, 32, 32, device="cpu")))
    assert not [n for n in program.graph.nodes
                if "profiler" in str(n.target)]
    assert serving.segmif_nodes(program) == export_cases.MODES["default"][1]
    assert "serve" not in _calls(before, span_totals())


def _buffer(data):
    import io

    return io.BytesIO(data)


def _leaf(gen, *shape, scale=0.5):
    return (torch.randn(shape, generator=gen) * scale).requires_grad_(True)


def _sr_attention(gen):
    q, k, v = (_leaf(gen, 1, n, 2, 4) for n in (5, 3, 3))
    return _sr_attention_grad(q, k, v, 0.5, forward=sr_attention_ref)


def _crosspath(gen):
    """The folded weights as ``CrossPath.folded_weights`` gives them:
    Linear weights [in, out], biases and LayerNorm scales."""
    c = 8

    def shape(key):
        if key.startswith(("wp", "wkv")):
            return (c, 2 * c)
        if key.startswith("we"):
            return (2 * c, c)
        return (2 * c,) if key.startswith("bp") else (c,)

    xs = [_leaf(gen, 1, 6, c) for _ in range(3)]
    w = {k: _leaf(gen, *shape(k)) for k in W_KEYS}
    out = _crosspath_grad(*xs, w, 0.5, 2, forward=crosspath_folded_ref)
    return out[0] + out[1]


def _drdb(gen):
    c, growth = 4, 2
    x = _leaf(gen, 1, c, 5, 6).detach().contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    dconvs = [(_leaf(gen, growth, c + growth * t, 3, 3, scale=0.2),
               _leaf(gen, growth)) for t in range(5)]
    bottleneck = (_leaf(gen, c, c + 5 * growth, 1, 1, scale=0.2),
                  _leaf(gen, c))
    return _drdb_grad(x, dconvs, bottleneck,
                      forward=lambda x, d, b, wpk: drdb_chain(x, d, b))


@pytest.mark.parametrize("name, call", [
    ("bwd/sr_attention", _sr_attention), ("bwd/crosspath", _crosspath),
    ("bwd/drdb", _drdb)])
def test_function_backward_opens_one_span_per_call(name, call):
    """Each kernel Function's recompute backward, with the plain forward
    standing in for the kernel: three calls, three spans."""
    gen = torch.Generator().manual_seed(4)
    before = span_totals()
    with spans_on():
        outs = [call(gen) for _ in range(3)]
        torch.autograd.backward([o.sum() for o in outs])
    assert _calls(before, span_totals()) == {name: 3}


def test_library_build_opens_its_span(monkeypatch):
    """``kernels/library`` times the build, also one that fails."""
    def refuse(extra_flags=None):
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "compile_library", refuse)
    monkeypatch.setattr(_build, "_lib", None)
    before = span_totals()
    with spans_on(), pytest.raises(_build.KernelBuildError):
        _build.library()
    assert _calls(before, span_totals()) == {"kernels/library": 1}
