"""Host ms per step spent in the fusion step's call, by the host's clock,
outside the profiled stretch (rank 0's under data parallelism). Layer:
the entry point, ``train/steps.py``."""
import statistics

UNIT = "ms"


def read(run):
    if run is None or run.kind != "train" or not run.dispatch_ms:
        return None
    return statistics.fmean(run.dispatch_ms)
