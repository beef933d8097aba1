"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic (``workloads/<cell>.json``),
makes the weights and inputs from ``--seed``, warms up every shape the
cell uses (the set-up), measures for ``--seconds``, checks what the timed
path produced against the plain reference, and prints as its last line
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics
from a profiled stretch of the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit. The compared numbers are also the last lines of standard error.

Exits 2 without a result when there is no CUDA device or fewer than the
cell needs, or the program is not this checkout's; 3 when the process
holds JAX or the JAX package after the window.
"""
from __future__ import annotations

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional, Tuple  # noqa: E402

from . import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(name: str, seed: int, seconds: float, trace: bool, device,
            workload: Optional[Dict] = None, config: Optional[Dict] = None,
            fault: Optional[str] = None, t0_wall: float = T0_WALL
            ) -> Tuple[int, Optional[Dict]]:
    """One run of cell ``name`` on ``device`` (a ``torch.device``), after
    the guards on the device: (exit code, result line or None).
    ``workload``, ``config`` and ``fault`` stand in for the cell's files
    and plant a fault (the harness's tests, on the CPU)."""
    import torch

    workload = workload or harness.load("workloads", name)
    config = config or harness.load("configs", workload["config"])
    cell = harness.Cell(name, workload, config, seed, seconds, trace,
                        t0_wall, device, fault)
    out = harness.driver(workload["driver"]).run(cell)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}: the benchmark "
              "measures the port alone", file=sys.stderr)
        return 3, None
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        info = {"platform": "gpu", "kind": kind}
    else:
        info = {"platform": "cpu", "kind": "cpu"}
    info.update(count=cell.chips, memory_peak_bytes=out.memory_peak_bytes)
    line = harness.result(cell, out, harness.benchmark(), info)
    for text in harness.check_lines(out):
        print(text, file=sys.stderr)
    return 0, line


def main(argv=None) -> int:
    args = parse(argv)
    workload = harness.load("workloads", args.workload)
    harness.set_cache_dirs()
    import torch

    chips = int(workload["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    wrong = harness.program_in_checkout()
    if wrong:
        print(f"portbench: {wrong}", file=sys.stderr)
        return 2
    rc, line = execute(args.workload, args.seed, args.seconds,
                       bool(args.trace), torch.device("cuda", 0), workload)
    sys.stderr.flush()
    if line is not None:
        print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
