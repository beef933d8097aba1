"""The port's seg-phase step (``train.steps.make_seg_train_step`` with the
seg phase's ``adamw_poly_grouped``, as the benchmark's ``train_seg``
driver builds them) against the benchmark's plain reference of the same
step (``portbench/reference/seg_train.py``), on the CPU in float32 (the
kernels' plain versions), on seeded random weights: MiT-B0 (four stages
of two blocks), 5 classes, 64x64 crops, batch 2, the head at widths 32
and 96 (the 256 : 768 ratio), with drop-path 0.1 and dropout 0.1 on, and
with both off. The drop-path and dropout masks are the program's, which
the reference applies (the driver records them the same way).

Compared, with the reasons for each tolerance:
 - the loss, relative 1e-5: float32 sums over 8,192 pixels, the program
   and the reference in another order (measured: at most 2e-7);
 - every leaf's gradient, ||program - reference|| over the larger of the
   leaf's reference norm and the median leaf's: the median leaf within
   1e-4 (measured: at most 1e-6), the worst within 1e-2. A ReLU in the
   head whose input rounds to the other side of 0 in one of the two
   float32 computations moves the gradients of the head's projections by
   up to 4e-3 on some seeds (measured, and gone when both sides run in
   float64);
 - one grouped AdamW update: the reference's update applied to the
   program's own gradients, against the program's weights after the step,
   each leaf within 1e-5 of its update's largest element plus 2 float32
   ulps of its largest weight (a norm's scale near 1 moves by about 6e-5,
   which float32 holds to 6e-8: the weights' own rounding, and float32
   rounding of lr x (u + wd p)); the update is near lr x sign(g), so this
   holds the groups' learning rates and decays;
 - the head BatchNorm's running mean and variance, relative 1e-5.

A control: the reference held in bfloat16 (every product's operands and
every value it makes, ``reference.precision.held_in``) must fail the
comparison, which shows that the tolerances are tight enough.
"""
from __future__ import annotations

import dataclasses
import functools
import statistics

import pytest
import torch

from portbench import harness, state
from portbench.drivers import train_seg
from portbench.program import build_model
from portbench.reference.seg_train import SEG, SegTrainer
from portbench.tests import tiny
from segmif_tpu_torch.models import mit, network
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
CELL = "b5h768_city1024_train_seg_b8"
SEED = 2 ** 31 + 21
DRAWS = 7


def _regularisers_off(monkeypatch):
    """Drop-path and dropout at 0 in the port, for this case only."""
    monkeypatch.setitem(mit.MIT_VARIANTS, "mit_b0", dataclasses.replace(
        mit.MIT_VARIANTS["mit_b0"], drop_path_rate=0.0))
    monkeypatch.setattr(network, "SegFormerHead", functools.partial(
        network.SegFormerHead, dropout_rate=0.0))


def _program_step(cfg, p):
    """One program step: (loss, first gradient, weights before and after,
    BatchNorm buffers after, masks)."""
    model = build_model(cfg, state.make_state(cfg, SEED, CPU), CPU,
                        torch.float32)
    step, st = train_seg.make_step(cfg, p, model, CPU)
    batch = train_seg.seg_pool(SEED, p, cfg, CPU)[0]
    before = {n: t.detach().clone() for n, t in st.params.items()}
    with train_seg.recorded_masks() as got:
        loss = float(step(st, batch, DRAWS)["loss"])
    b1 = p["betas"][0]
    grads = {n: mu / (1 - b1) for n, mu in st.opt_state.mu.items()}
    after = {n: t.detach().clone() for n, t in st.params.items()}
    stats = {n: t.detach().clone() for n, t in st.batch_stats.items()}
    return loss, grads, before, after, stats, train_seg.step_masks(got), \
        batch


def _gaps(got, ref):
    norms = {n: float(ref[n].norm()) for n in ref}
    med = statistics.median(norms.values())
    return {n: float((got[n] - ref[n]).norm()) / max(norms[n], med)
            for n in ref}


@pytest.mark.parametrize("dim,regularisers,precision", [
    (32, True, "float32"), (32, False, "float32"), (96, True, "float32"),
    (96, False, "float32"), (96, True, "bfloat16")])
def test_seg_step_against_reference(dim, regularisers, precision,
                                    monkeypatch):
    cfg = dict(tiny.config(harness.load("workloads", CELL)["config"]),
               decoder_dim=dim, num_classes=5)
    p = dict(tiny.workload(CELL)["params"], check_steps=1)
    if not regularisers:
        _regularisers_off(monkeypatch)
        p.update(drop_path=0.0, dropout=0.0)
    loss, grads, before, after, stats, masks, batch = _program_step(cfg, p)
    assert len(masks["drop_path"]) == (2 * (sum(cfg["depths"]) - 1)
                                       if regularisers else 0)
    assert (masks["dropout"] is not None) == regularisers

    sd = state.make_state(cfg, SEED, CPU)
    ref = SegTrainer(cfg, sd, train_seg.hyper(p), precision)
    ref_grads, ref_loss = ref.step(batch, masks)
    ref_grads = {k[len(SEG):]: v for k, v in ref_grads.items()}
    adamw = SegTrainer(cfg, sd, train_seg.hyper(p))
    adamw.adamw({SEG + n: g for n, g in grads.items()})

    gaps = _gaps(grads, ref_grads)
    ulp = torch.finfo(torch.float32).eps
    update = {n: float((after[n] - adamw.params[SEG + n].detach()).abs()
                       .max()) / (1e-5 * float((after[n] - before[n]).abs()
                                               .max())
                                  + 2 * ulp * float(before[n].abs().max()))
              for n in after}
    stat_gaps = {n: float((t - ref.stats[SEG + n]).norm()
                          / ref.stats[SEG + n].norm())
                 for n, t in stats.items()}
    held = {
        "loss": abs(loss - ref_loss) / abs(ref_loss) < 1e-5,
        "grad_median": statistics.median(gaps.values()) < 1e-4,
        "grad_worst": max(gaps.values()) < 1e-2,
        "update": max(update.values()) <= 1.0,
        "stats": max(stat_gaps.values()) < 1e-5,
    }
    if precision == "float32":
        assert all(held.values()), (held, loss, ref_loss,
                                    sorted(gaps.items(), key=lambda kv:
                                           -kv[1])[:3], stat_gaps)
    else:
        assert not all(held.values()), held
