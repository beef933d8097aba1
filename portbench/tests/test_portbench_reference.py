"""The plain reference against the port on the CPU, at a small size in
float32 (the port's kernels run their plain versions there), on seeded
weights: the serving closure and the fusion train step agree with it, a
planted fault fails it, its control in float8 fails the cells' limits,
and no module of it imports the program or JAX."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import calibrate, harness, state
from portbench.drivers import serve_closed, train_fusion
from portbench.program import build_model
from portbench.tests import tiny

CPU = torch.device("cpu")
REFERENCE = Path(harness.HERE) / "reference"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 77])
def test_serving_closure_agrees(seed):
    cfg, p = tiny.config(), tiny.workload("b3_vga_serve_b8")["params"]
    nums = calibrate.serve_readings(cfg, p, seed, CPU, control=False,
                                    faults=(), seconds=0.5)["program"]
    assert nums["fused_max_abs"] < 1e-5
    assert nums["seg_logit_gap"] < 1e-5


def test_train_step_agrees():
    """One fusion step: its losses, the tail's gradient and change, and
    every leaf's. (Over more steps AdamW's first updates, lr times the
    sign of a gradient, turn float32 noise on the gradients near zero
    into differences of up to 2 lr a weight, and the later losses part at
    about 1e-4. The tail's gradient sums terms that cancel: float32 reads
    up to 3e-4 of the median leaf's norm on some seeds.)"""
    cfg = tiny.config()
    p = dict(tiny.workload("b3_vga_train_fusion_b8")["params"],
             check_steps=1)
    got = calibrate.train_side(cfg, p, 11, CPU)
    nums = train_fusion.compare(got, train_fusion.reference(cfg, p, 11, CPU))
    assert nums["loss_rel_gap"] < 1e-5
    assert nums["loss_fusion_rel_gap"] < 1e-5
    assert nums["grad_norm_gap"] < 1e-3
    assert nums["update_norm_gap"] < 1e-3
    for name in ("grad_norm_gap", "update_norm_gap"):
        assert nums[name + "_all_worst"] < 1e-3, (name, nums)
        assert nums[name + "_all_median"] < 1e-4, (name, nums)


def test_planted_fault_fails():
    """The program served with the fusion tail's last bias moved by 0.1:
    the check sees it."""
    cfg, p = tiny.config(), tiny.workload("b3_vga_serve_b8")["params"]
    limits = harness.load("workloads", "b3_vga_serve_b8")["limits"]
    from segmif_tpu_torch.serving import make_serving_fn

    sd = state.make_state(cfg, 4, CPU)
    sd["fusion.conv22.bias"] = sd["fusion.conv22.bias"] + 0.1
    serve = make_serving_fn(build_model(cfg, sd, CPU, torch.float32),
                            device=CPU)
    pool = state.serve_pool(4, p["pool"], p["batch"], cfg["height"],
                            cfg["width"], CPU)
    kept = []
    for i in range(2):
        slot = serve_closed.Slot(p["batch"], cfg["height"], cfg["width"], CPU)
        slot.fused[:], slot.pred[:] = serve(**pool[i])
        kept.append((i, slot))
    nums = serve_closed.reference_checks(cfg, 4, p, {"program": kept},
                                         CPU)["program"]
    assert nums["fused_max_abs"] > limits["fused_max_abs"]


def test_control_fails_the_serving_limits():
    """The reference with float8 operands in the program's place fails a
    serving cell's numbers."""
    cfg, p = tiny.config(), tiny.workload("b3_vga_serve_b8")["params"]
    limits = harness.load("workloads", "b3_vga_serve_b8")["limits"]
    nums = calibrate.serve_readings(cfg, p, 8, CPU, control=True,
                                    faults=(), seconds=0.5)["control_fp8"]
    assert any(nums[k] > limits[k] for k in limits), nums


def test_control_fails_the_training_limits():
    cfg = tiny.config()
    p = tiny.workload("b3_vga_train_fusion_b8")["params"]
    limits = harness.load("workloads", "b3_vga_train_fusion_b8")["limits"]
    ref = train_fusion.reference(cfg, p, 9, CPU)
    low = train_fusion.reference(cfg, p, 9, CPU, "float8_e4m3")
    nums = train_fusion.compare(low, ref)
    assert any(nums[k] > limits[k] for k in limits), nums


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    banned = {"segmif_tpu_torch", "segmif_tpu", "jax", "jaxlib", "flax"}
    for path in REFERENCE.glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & banned, (path, tops & banned)
    code = ("import sys, portbench.reference.model, portbench.reference.train;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'segmif_tpu_torch', 'segmif_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
