"""Host ms per batch spent in the serving closure's call (its enqueue: the
call does not synchronise), by the host's clock, outside the profiled
stretch. Layer: the entry point, ``serving.py``."""
import statistics

UNIT = "ms"


def read(run):
    if run is None or run.kind != "serve" or not run.dispatch_ms:
        return None
    return statistics.fmean(run.dispatch_ms)
