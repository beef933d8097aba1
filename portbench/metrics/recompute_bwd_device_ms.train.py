"""Device ms per step of the kernels launched by the backward passes of
the three kernel Functions (``kernels/attention.py``, ``ffm.py``,
``drdb.py``), which recompute their plain versions."""
from portbench.trace import BACKWARD

UNIT = "ms"


def read(run):
    if run is None or run.kind != "train":
        return None
    return run.per_unit_ms(lambda k: bool(k[BACKWARD]))
