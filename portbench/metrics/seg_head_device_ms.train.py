"""Device ms per step of the kernels launched inside the decode head's
forward (``models/segformer_head.py``): the rows under the ``pb:seg_head``
range that the driver's forward hooks open around the seg network's
``decoder``, from the profiled stretch."""
from portbench.trace import LAYER

UNIT = "ms"


def read(run):
    if run is None or run.kind != "train":
        return None
    return run.per_unit_ms(lambda k: k[LAYER] == "seg_head")
