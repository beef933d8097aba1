"""The frozen yardstick: the roofline arithmetic reproduces the bound
column of the port's kernel table at chip_smoke.py's phase-4 shapes, the
kernel classes are the program's, and the model FLOP counter agrees with
a hand count of one DRDB and with torch's FLOP counter run over the plain
reference."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, state
from portbench.reference.model import Reference
from portbench.tests import tiny
from portbench.yardstick import classes, flops, roofline

B, H, W = 8, 480, 640


def sr_bound_ms() -> float:
    """The four mit_b3 stage shapes summed, bf16, M = 300, D = 64."""
    ops = moved = 0
    for n, h in ((19200, 1), (4800, 2), (1200, 5), (300, 8)):
        o, m, kind = roofline.sr_attention_cost((B, n, h, 64), (B, 300, h, 64),
                                                "bf16")
        ops, moved = ops + o, moved + m
    return roofline.bound(ops, kind, moved)


@pytest.mark.parametrize("name,got,want,by", [
    ("sr_attention", lambda: sr_bound_ms(), 0.026, "bytes"),
    ("ffm_grams", lambda: roofline.bound(*_swap(roofline.ffm_grams_cost(
        (B, H * W, 64), "bf16"))), 0.282, "bytes"),
    ("ffm_apply", lambda: roofline.bound(*_swap(roofline.ffm_apply_cost(
        (B, H * W, 64), "bf16"))), 0.470, "bytes"),
    ("drdb_tail", lambda: roofline.bound(*_swap(roofline.drdb_tail_cost(
        (B, 64, H, W), "bf16"))), 0.423, "bytes"),
    ("drdb_growth", lambda: roofline.bound(*_swap(roofline.drdb_growth_cost(
        (B, 64, H, W), "bf16"))), 0.916, "operations"),
])
def test_bound_column(name, got, want, by):
    b = got()
    assert round(b["bound_ms"], 3) == want, (name, b)
    assert b["bound_by"] == by


def _swap(cost):
    ops, moved, kind = cost
    return ops, kind, moved


def test_recorded_shapes_give_the_same_bounds():
    shapes = [[B, 64, H, W], [184320], [160]]
    got = roofline.op_bound_ms("segmif::drdb_growth", shapes,
                               ["c10::BFloat16", "c10::BFloat16", "float"])
    assert round(got[0], 3) == 0.916 and got[1] == "operations"
    assert roofline.op_bound_ms("segmif::drdb_int8_growth", shapes,
                                ["c10::BFloat16"]) is None
    assert roofline.op_bound_ms("segmif::sr_attention", [], []) is None
    f32 = roofline.op_bound_ms("segmif::ffm_apply", [[B, H * W, 64]],
                               ["float"])
    bf16 = roofline.op_bound_ms("segmif::ffm_apply", [[B, H * W, 64]],
                                ["c10::BFloat16"])
    assert f32[0] > bf16[0]


def test_classes_are_the_programs():
    from segmif_tpu_torch import profile_serving

    assert classes.CLASSES == profile_serving.CLASSES
    for name in ("sr_attention_kernel<64>", "void at::native::"
                 "vectorized_elementwise_kernel", "nccl", "growth_kernel"):
        assert classes.kernel_class(name) == profile_serving.kernel_class(
            name)
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert classes.busy_us(spans) == profile_serving.busy_us(spans) == 4.0


def test_drdb_hand_count():
    """5 dilated 3x3 convs with 64..192 inputs and growth 32, and a 1x1
    conv from 224 to 64: about 397 kFLOP a pixel, 122 GFLOP a block per
    480 x 640 image."""
    cfg = harness.load("configs", "segmif_mit_b3_vga")
    per_pixel = 2 * 9 * 32 * (64 + 96 + 128 + 160 + 192) + 2 * 224 * 64
    assert per_pixel == 397312
    assert flops.drdb_flops(cfg, 1) == per_pixel
    assert abs(flops.drdb_flops(cfg, H * W) / 1e9 - 122.05) < 0.01


def test_served_pair_counts():
    b3 = harness.load("configs", "segmif_mit_b3_vga")
    b5 = harness.load("configs", "segmif_mit_b5_1080p")
    assert abs(flops.serve_flops_per_pair(b3) / 1e12 - 0.7528) < 1e-3
    assert abs(flops.serve_flops_per_pair(b5) / 1e12 - 7.066) < 1e-2
    f, s, t = (flops.fusion_flops(b3, H, W), flops.seg_flops(b3, H, W),
               flops.mit_flops(b3, H, W, stages=2))
    assert flops.train_flops_per_pair(b3) == 3 * f + 2 * s + t


def test_counter_agrees_with_torch_on_the_reference():
    """torch's FLOP counter over the plain reference's served pair at a
    small size: the same count, but for the colour conversion's 3 x 3
    matmul (18 FLOP a pixel), which the yardstick leaves out."""
    cfg = tiny.config()
    sd = state.make_state(cfg, 5, torch.device("cpu"))
    ref = Reference(cfg, sd)
    ir = torch.rand(1, cfg["height"], cfg["width"], 1)
    vis = torch.rand(1, cfg["height"], cfg["width"], 3)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.serve(ir, vis)
    colour = 2 * 3 * 3 * cfg["height"] * cfg["width"]
    assert counter.get_total_flops() - colour == \
        flops.serve_flops_per_pair(cfg)
