"""Device ms per batch of the kernels launched inside the seg network's
modules: the MiT encoder (``models/mit.py``) in the guide's pass and the
seg pass, and the decode head (``models/segformer_head.py``)."""
from portbench.trace import LAYER

UNIT = "ms"


def read(run):
    if run is None or run.kind != "serve":
        return None
    return run.per_unit_ms(lambda k: k[LAYER] == "mit")
