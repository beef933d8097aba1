"""The seg-phase driver (``drivers/train_seg.py``) on the CPU at a tiny
configuration (``tiny``: MiT-B0's widths and depths, 64 x 64 crops,
batch 2, float32, the cell's 768-wide head): a run reports correct on the
program and its traced run reads the new per-layer metrics; each planted
fault and the float8 control come out not correct under the cell's
limits; a run loads none of ``harness.FORBIDDEN``."""
from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import calibrate_seg, harness
from portbench.drivers import train_seg
from portbench.run import execute
from portbench.tests import tiny

CPU = torch.device("cpu")
CELL = "b5h768_city1024_train_seg_b8"
NEW = ("backward_host_ms.train", "optimizer_host_ms.train")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def run_tiny(trace=False, fault=None):
    """A run of the tiny cell; a traced one with a window long enough to
    reach its profiled stretch on a loaded host."""
    w = tiny.workload(CELL)
    rc, line = execute(CELL, 2 ** 31 + 5, 4.0 if trace else 1.0, trace,
                       CPU, w, tiny.config(w["config"]), fault, time.time())
    assert rc == 0
    return line


def test_run_is_correct_and_reads_its_metrics():
    line = run_tiny()
    assert line["correct"] is True, line["checks"]
    assert sorted(line["metrics"]) == sorted(
        harness.end_to_end_names(harness.benchmark(), CELL, {}))
    traced = run_tiny(trace=True)
    assert traced["correct"] is True
    # the CPU has no device rows: the device metrics read nothing here
    for name in NEW + ("host_dispatch_ms.train", "step_mfu.train"):
        assert traced["metrics"][name]["value"] > 0, name
    assert set(traced["metrics"]) <= set(
        harness.per_layer_names(harness.benchmark(), CELL))


@pytest.mark.parametrize("fault", train_seg.FAULTS)
def test_planted_fault_is_not_correct(fault):
    assert run_tiny(fault=fault)["correct"] is False


def test_float8_control_is_not_correct():
    w = tiny.workload(CELL)
    nums, _ = calibrate_seg.readings(tiny.config(w["config"]), w["params"], 9,
                                  CPU, True, ())
    limits = w["limits"]
    assert all(nums["program"][k] <= limits[k] for k in limits)
    assert any(nums["control_fp8"][k] > limits[k] for k in limits), nums


def test_masks_at_another_rate_are_not_correct():
    """``mask_keep_z`` holds the recorded masks to the reference's keep
    probabilities: dropout drawn at 0.95 instead of 0.9 reads far above
    the cell's limit, draws at the schedule's rate below it."""
    keep = {"drop_path": [0.9, 0.9, 0.95, 0.95], "dropout": 0.9}
    g = torch.Generator().manual_seed(3)

    def masks(dropout_keep):
        return [{"drop_path": [(torch.rand(8, 1, 1, generator=g) < p).float()
                               for p in keep["drop_path"]],
                 "dropout": torch.rand(2, 64, 32, 32, generator=g)
                 < dropout_keep} for _ in range(3)]

    limit = tiny.workload(CELL)["limits"]["mask_keep_z"]
    assert train_seg.mask_keep_z(masks(0.9), keep) < limit
    assert train_seg.mask_keep_z(masks(0.95), keep) > limit
    with pytest.raises(ValueError):
        train_seg.mask_keep_z(masks(0.9), {**keep, "drop_path": [0.9]})


def test_span_metrics_read_nothing_without_the_spans():
    """A program whose seg step opens no spans (the parent of the spans'
    change): the metrics read None and do not raise."""
    class Run:
        kind = "train"
        span_totals = {"seg/encoder": (5_000_000, 4)}

    for name in NEW:
        assert harness.metric(name).read(Run()) is None
        assert harness.metric(name).read(None) is None


def test_run_loads_nothing_forbidden():
    code = (
        "import json, sys, time, torch\n"
        "torch.set_num_threads(4)\n"
        "from portbench import harness\n"
        "from portbench.run import execute\n"
        "from portbench.tests import tiny\n"
        f"w = tiny.workload({CELL!r})\n"
        "rc, line = execute(w['name'], 3, 4.0, True, torch.device('cpu'), "
        "w, tiny.config(w['config']), None, time.time())\n"
        "import portbench.calibrate_seg\n"
        "print(json.dumps([rc, harness.forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [0, []]
