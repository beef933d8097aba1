"""Device ms per batch of the kernels launched inside the fusion net's
forward (``models/fusion.py``), from the profiled stretch."""
from portbench.trace import LAYER

UNIT = "ms"


def read(run):
    if run is None or run.kind != "serve":
        return None
    return run.per_unit_ms(lambda k: k[LAYER] == "fusion")
