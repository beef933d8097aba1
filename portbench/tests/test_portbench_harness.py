"""The harness's own guards, on the CPU without a card: what a run
imports, the files found by name, the result line's keys, the names and
units of BENCHMARK.json against the benchmark's contract, each per-layer
metric's cells, the planted faults a run must call not correct, and the
refusals without a card or without the program."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.run import execute
from portbench.tests import tiny

CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device",
             "breakdown", "checks"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def bench():
    return harness.benchmark()


def run_tiny(cell, trace=False, fault=None, seconds=1.0):
    w = tiny.workload(cell)
    rc, line = execute(cell, 2 ** 31 + 5, seconds, trace, CPU, w,
                       tiny.config(w["config"]), fault, time.time())
    assert rc == 0
    return line


# ------------------------------------------------------------ imports

def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(["segmif_tpu_torch.serving", "numpy",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["segmif_tpu.models", "jax.numpy",
                                      "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "segmif_tpu"]


def test_import_closure_of_a_run():
    """Everything a run imports, in a fresh process: no jax, jaxlib, flax
    or segmif_tpu by whole top-level name."""
    code = (
        "import sys, importlib\n"
        "from portbench import run, calibrate, harness, trace\n"
        "for d in ('serve_closed', 'train_fusion', 'train_fusion_dp'):\n"
        "    harness.driver(d)\n"
        "for m in harness.per_layer_names(harness.benchmark(), '') or []:\n"
        "    harness.metric(m)\n"
        "for p in harness.per_layer_names(None, ''):\n"
        "    harness.metric(p)\n"
        "import segmif_tpu_torch.serving, segmif_tpu_torch.train.steps\n"
        "import segmif_tpu_torch.parallel.dist, segmif_tpu_torch.parallel.mesh\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ------------------------------------------------------- the contract

def test_benchmark_json_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    assert 1 <= len(cells) <= 24 and 1 <= len(configs) <= 24
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (harness.ROOT / c["file"]).is_file()
        assert json.loads((harness.ROOT / c["file"]).read_text())[
            "reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in cells.values())
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        own = harness.load("workloads", w["name"])
        assert {k: own[k] for k in w} == w, "workload file differs"
    names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= set(cells)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert "bound" not in m and m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200
    for p in (harness.HERE).rglob("*"):
        rel = p.relative_to(harness.ROOT).as_posix()
        if "__pycache__" not in rel:
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
    assert len(json.dumps(b)) < 64 * 1024


def test_each_metric_cell_reports_what_it_moves():
    """A per-layer metric's cells report the end-to-end metric it moves,
    and every cell reports setup_s, another end-to-end metric and a
    per-layer metric."""
    b = bench()
    cells = [w["name"] for w in b["workloads"]]
    for cell in cells:
        e2e = harness.end_to_end_names(b, cell, {})
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.per_layer_names(b, cell)
        for m in b["per_layer"]:
            if cell in m.get("workloads", cells):
                assert m["moves"] in e2e, (cell, m["name"])
    for m in b["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert harness.metric(m["name"]).UNIT == m["unit"]


# -------------------------------------------------------- runs on the CPU

@pytest.mark.parametrize("cell", ["b3_vga_serve_b8",
                                  "b3_vga_train_fusion_b8"])
def test_result_line(cell):
    line = run_tiny(cell)
    assert set(line) <= LINE_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True
    want = harness.end_to_end_names(bench(), cell, {})
    assert sorted(line["metrics"]) == sorted(want)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and UNIT.match(m["unit"])
    traced = run_tiny(cell, trace=True)
    assert set(traced) <= LINE_KEYS
    assert set(traced["metrics"]) <= set(harness.per_layer_names(bench(),
                                                                 cell))
    assert {"busy_s", "window_s"} <= set(traced["device"])


@pytest.mark.parametrize("cell,fault", [
    ("b3_vga_serve_b8", "answer"), ("b3_vga_serve_b8", "half_batch"),
    ("b3_vga_train_fusion_b8", "unchanged"),
    ("b3_vga_train_fusion_b8", "half_batch"),
    ("b3_vga_train_fusion_b8", "drdb_grad_zeroed"),
    ("b3_vga_train_fusion_b8", "ffm_grad_zeroed"),
    ("b3_vga_train_fusion_dp4_b32", "no_exchange"),
    ("b3_vga_train_fusion_dp4_b32", "drdb_grad_zeroed"),
])
def test_planted_fault_is_not_correct(cell, fault):
    """The rest of a run, with the timed path broken underneath: correct
    comes out false."""
    assert run_tiny(cell, fault=fault)["correct"] is False


def test_data_parallel_run_is_correct():
    assert run_tiny("b3_vga_train_fusion_dp4_b32")["correct"] is True


def test_added_files_are_found(tmp_path):
    """A workload file, a traffic of an existing driver and a per-layer
    metric file added to a copy of the folder, with entries added to a
    copy of BENCHMARK.json: found and run, nothing else edited."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    w = tiny.workload("b3_vga_serve_b8")
    w.update(name="b3_vga_serve_b4_added", traffic="serve_closed_b4_q1",
             why="an added cell")
    w["params"].update(batch=2, in_flight=1)
    (tmp_path / "portbench/workloads/b3_vga_serve_b4_added.json").write_text(
        json.dumps(w))
    (tmp_path / "portbench/metrics/batches_traced.serve.py").write_text(
        "UNIT = 'count'\n\n\ndef read(run):\n"
        "    return None if run is None else float(run.units)\n")
    b["workloads"].append({k: w[k] for k in ("name", "config", "traffic",
                                             "chips", "why")})
    for m in b["end_to_end"] + b["per_layer"]:
        if "serve_pairs_per_s" in (m["name"], m.get("moves")):
            m["workloads"].append(w["name"])
    b["per_layer"].append({"name": "batches_traced.serve", "unit": "count",
                           "better": "higher", "source": "program_counter",
                           "layer": "entry point: serving.py",
                           "moves": "serve_pairs_per_s",
                           "workloads": [w["name"]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import json, sys, time, torch\n"
        "torch.set_num_threads(4)\n"
        "from portbench import harness\n"
        "from portbench.run import execute\n"
        "from portbench.tests import tiny\n"
        "assert str(harness.HERE).startswith(sys.argv[1]), harness.HERE\n"
        "w = harness.load('workloads', 'b3_vga_serve_b4_added')\n"
        "rc, line = execute(w['name'], 7, 1.0, True, torch.device('cpu'), w,"
        " tiny.config(), None, time.time())\n"
        "print(json.dumps(line))\n")
    env = {"PYTHONPATH": f"{tmp_path}:{harness.ROOT}", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["batches_traced.serve"]["value"] >= 1


# ------------------------------------------------------------- refusals

def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "b3_vga_serve_b8", "--seed", str(2 ** 33),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.ROOT,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_folder_alone_is_refused(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder: no program, so no result."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    code = ("from portbench import harness; "
            "print(harness.program_in_checkout() is not None)")
    env = {"PYTHONPATH": str(tmp_path), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.stdout.strip() == "True", out.stderr
    cmd = bench()["command"] + ["--workload", "b3_vga_serve_b8", "--seed",
                                "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cell_on_the_card(card):
    """One short run of the first cell on the card, through the command."""
    cmd = bench()["command"] + ["--workload", "b3_vga_serve_b8", "--seed",
                                str(2 ** 31 + 99), "--seconds", "3",
                                "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
