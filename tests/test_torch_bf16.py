"""The port's bf16 pipeline against its own f32 pipeline, on the CPU.

``segmif_tpu_torch.drift`` holds bf16 serving to f32 under the limits the
JAX package applies on the TPU (tests/test_bf16_drift.py:88-100): fused-Y
max abs < 0.02, seg argmax agreement > 0.95, logits max abs < 1 std of the
f32 logits. chip_smoke.py and the card test apply them to mit_b3 at
480x640; here the plain versions run a small mit_b0 pipeline (64x64,
batch 2) in both dtypes on the CPU, with weights at the reference modules'
scale, and the limit logic is pinned on constructed outputs. (The JAX CPU
backend cannot run bf16 dots, so no JAX side takes part.)
"""
import copy

import pytest
import torch

from segmif_tpu_torch import drift
from segmif_tpu_torch.models.network import JointPipeline


def _pipeline(seed):
    model = drift.init_reference_scale(JointPipeline("mit_b0"),
                                       torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 10)
    ir = torch.rand((2, 64, 64, 1), generator=g)
    vis = torch.rand((2, 64, 64, 3), generator=g)
    return model.eval(), ir, vis


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_pipeline_within_limits_of_f32(seed):
    """bf16 against f32 on the same weights and inputs: fused-Y max abs
    measured 0.0039 and 0.0029 of the 0.02 limit, argmax agreement 0.996
    and 1.0, logits 0.04 and 0.02 std."""
    model, ir, vis = _pipeline(seed)
    ref = drift.pipeline_outputs(model, ir, vis, torch.float32, "cpu")
    got = drift.pipeline_outputs(model, ir, vis, torch.bfloat16, "cpu")
    assert ref[0].shape == (2, 64, 64, 1) and ref[1].shape == (2, 16, 16, 9)
    d = drift.drift(ref, got)
    assert drift.within_limits(d), drift.describe(d)
    # the copies ran; the caller's model is untouched
    assert next(model.parameters()).dtype == torch.float32


@pytest.mark.parametrize("drdb,caught", [(1, True), (3, False), (4, False)])
def test_dropped_tail_bias_against_the_limits(drdb, caught):
    """A bf16 run with one DRDB's tail bias dropped, against f32 on the true
    weights. DRDB1's fails the fused-Y limit at this seed (0.027 against
    0.02); the same fault in DRDB3 or DRDB4, nearer the output, stays
    inside every limit: the limits are coarse, and the per-element kernel
    checks are the fine ones."""
    model, ir, vis = _pipeline(0)
    ref = drift.pipeline_outputs(model, ir, vis, torch.float32, "cpu")
    bad = copy.deepcopy(model)
    with torch.no_grad():
        getattr(bad.fusion, f"DRDB{drdb}").conv.bias.zero_()
    d = drift.drift(ref, drift.pipeline_outputs(bad, ir, vis, torch.bfloat16,
                                                "cpu"))
    assert drift.within_limits(d) != caught, drift.describe(d)
    assert (d["fused_y_max_abs"] > 0.02) == caught


def _outputs():
    g = torch.Generator().manual_seed(3)
    y = torch.rand((2, 8, 8, 1), generator=g)
    logits = torch.randn((2, 10, 10, 9), generator=g)
    logits[..., 0] = 5.0          # class 0 wins everywhere,
    logits[..., 1] = 4.75         # class 1 a close second
    return y, logits


def _perturbed(case):
    y, logits = _outputs()
    y, logits = y.clone(), logits.clone()
    std = _outputs()[1].std().item()
    name, amount = case
    if name == "fused_y":
        y[1, 3, 4, 0] += amount
    elif name == "argmax":        # flip the argmax at a share of pixels
        flat = logits.reshape(-1, 9)
        flat[:round(amount * flat.shape[0]), 1] += 0.5
    elif name == "logits":
        logits[0, 2, 2, 5] += amount * std
    return y, logits


@pytest.mark.parametrize("case,ok", [
    (("none", 0.0), True),
    (("fused_y", 0.019), True),
    (("fused_y", -0.021), False),
    (("argmax", 0.04), True),
    (("argmax", 0.06), False),
    (("logits", 0.9), True),
    (("logits", -1.1), False),
])
def test_drift_limit_logic(case, ok):
    """Each of the three limits on constructed outputs: a change just
    inside a limit passes, just outside fails, in either direction."""
    d = drift.drift(_outputs(), _perturbed(case))
    assert drift.within_limits(d) == ok, drift.describe(d)


@pytest.mark.parametrize("change,ok", [("shift", True),
                                       ("checkerboard", False)])
def test_drift_ssim_limit(change, ok):
    """The SSIM limit on a smooth fused Y: a uniform shift of 0.015 keeps
    the structure (SSIM about 0.9996) and passes; a +-0.015 checkerboard
    stays inside the max-abs limit but breaks the structure, and only the
    SSIM limit fails it."""
    ramp = torch.linspace(0.3, 0.7, 16)
    y = (ramp[:, None] + ramp[None, :] * 0.5).expand(2, 16, 16)[..., None]
    logits = torch.randn((2, 4, 4, 9), generator=torch.Generator()
                         .manual_seed(4))
    board = (torch.arange(16)[:, None] + torch.arange(16)[None, :]) % 2
    delta = (torch.full_like(y, 0.015) if change == "shift" else
             (board * 2 - 1)[None, :, :, None] * 0.015)
    d = drift.drift((y, logits), (y + delta, logits))
    assert d["fused_y_max_abs"] < 0.02
    assert drift.within_limits(d) == ok, drift.describe(d)
    assert (d["fused_y_ssim"] > 0.99) == ok


def test_reference_scale_init():
    """Every conv and linear weight and bias lies within 1/sqrt(fan_in),
    spread over it (not the JAX initialisers' normal or zero biases); norm
    layers are reset and the PReLU slope is 0.25; the same seed gives the
    same weights."""
    a = drift.init_reference_scale(JointPipeline("mit_b0"),
                                   torch.Generator().manual_seed(5))
    b = drift.init_reference_scale(JointPipeline("mit_b0"),
                                   torch.Generator().manual_seed(5))
    for mod in a.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            bound = mod.weight[0].numel() ** -0.5
            assert mod.weight.abs().max().item() <= bound
            assert mod.weight.abs().max().item() > 0.5 * bound
            if mod.bias is not None and mod.bias.numel() > 8:
                assert 0 < mod.bias.abs().max().item() <= bound
        elif isinstance(mod, torch.nn.LayerNorm):
            assert bool((mod.weight == 1).all() and (mod.bias == 0).all())
    assert a.fusion.relu.weight.item() == 0.25
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
