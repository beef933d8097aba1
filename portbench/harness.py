"""What every run shares: finding a cell's files by name, the guards, the
cache directories, and the result line.

A cell is ``workloads/<cell>.json``: its configuration's name (the file
``configs/<config>.json``), its traffic's name and driver
(``drivers/<driver>.py``, which reads the traffic's parameters), the
chips it needs, why it exists, and the limits of its correctness check.
A per-layer metric is ``metrics/<name>.py``, whose ``read(run)`` returns
a number or None. ``BENCHMARK.json`` at the repository's root says which
metrics each cell reports. Adding a cell, a configuration or a metric
adds files and entries; it edits none.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "segmif_tpu")
PROGRAM = "segmif_tpu_torch"
CACHE = ROOT / ".portbench_cache"
GIB = float(1 << 30)


def load(kind: str, name: str) -> Dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def benchmark() -> Optional[Dict]:
    path = ROOT / "BENCHMARK.json"
    return json.loads(path.read_text()) if path.is_file() else None


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``segmif_tpu_torch`` is not ``segmif_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def set_cache_dirs(root: Path = CACHE) -> None:
    """Every build and kernel cache of the run at a fixed path inside the
    checkout. The port's own kernel library builds into
    ``segmif_tpu_torch/kernels/build/<hash>/``, inside it too."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(root / sub)
    os.environ["USE_FLAX"] = "0"


def program_in_checkout() -> Optional[str]:
    """None when the port imported is this checkout's; else what is
    wrong."""
    spec = importlib.util.find_spec(PROGRAM)
    if spec is None or spec.origin is None:
        return f"the program ({PROGRAM}) is not in this checkout"
    origin = Path(spec.origin).resolve()
    if ROOT not in origin.parents:
        return f"{PROGRAM} resolves to {origin}, outside {ROOT}"
    return None


@dataclasses.dataclass
class Cell:
    """One run of one cell, as a driver gets it."""
    name: str
    workload: Dict
    config: Dict
    seed: int
    seconds: float
    trace: bool
    t0_wall: float            # process start, time.time()
    device: Any = None        # torch.device of rank 0
    fault: Optional[str] = None   # a planted fault (the harness's tests)

    @property
    def params(self) -> Dict:
        return self.workload["params"]

    @property
    def limits(self) -> Dict:
        return self.workload["limits"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


@dataclasses.dataclass
class Outcome:
    """What a driver returns: the end-to-end values {name: (value, unit)},
    requests attempted and failed, the device's numbers, the compared
    numbers with their limits, and the traced run's readings (a
    ``trace.TracedRun``) when traced."""
    e2e: Dict[str, tuple]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Dict]
    run: Any = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] is not None and math.isfinite(c["value"])
            and c["value"] <= c["limit"] for c in self.checks)


def metric(name: str):
    """The per-layer metric ``metrics/<name>.py`` (the name may hold
    dots), as a module with ``UNIT`` and ``read(run)``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def _applies(entry: Dict, cell: str, e2e_of_cell=None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return e2e_of_cell is None or entry.get("moves") in e2e_of_cell


def end_to_end_names(bench: Optional[Dict], cell: str,
                     produced: Dict) -> List[str]:
    if bench is None:
        return list(produced)
    return [m["name"] for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer_names(bench: Optional[Dict], cell: str) -> List[str]:
    if bench is None:
        return sorted(p.stem for p in (HERE / "metrics").glob("*.py")
                      if p.stem != "__init__")
    e2e = set(end_to_end_names(bench, cell, {}))
    return [m["name"] for m in bench["per_layer"]
            if _applies(m, cell, e2e)]


def result(cell: Cell, out: Outcome, bench: Optional[Dict],
           device: Dict) -> Dict:
    """The result line's object; ``checks`` comes last."""
    metrics: Dict[str, Dict] = {}
    breakdown = None
    if not cell.trace:
        for name in end_to_end_names(bench, cell.name, out.e2e):
            if name in out.e2e:
                value, unit = out.e2e[name]
                metrics[name] = {"value": value, "unit": unit}
    else:
        for name in per_layer_names(bench, cell.name):
            mod = metric(name)
            value = mod.read(out.run)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
        breakdown = out.run.breakdown()
        device = dict(device, busy_s=out.run.busy_s(),
                      window_s=out.run.window_s())
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in out.checks}
    return line


def check_lines(out: Outcome) -> List[str]:
    return [f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}; "
            f"{c['what']})" for c in out.checks]


# ------------------------------------------------- the device, or the CPU
# A run measures on the card; the harness's tests drive the same code on
# the CPU (the kernels' plain versions), where these do nothing.

def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _HostEvent:
    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass


def event(device):
    import torch

    return torch.cuda.Event() if device.type == "cuda" else _HostEvent()


def memory_peak(device) -> int:
    import torch

    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free_memory(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
