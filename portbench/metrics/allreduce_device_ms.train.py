"""Device ms per step of the NCCL kernels (``parallel/dist.py``'s
collectives), averaged over the ranks."""
from portbench.trace import NAME

UNIT = "ms"


def read(run):
    if run is None or run.kind != "train" or run.chips < 2:
        return None
    return run.per_unit_ms(lambda k: "nccl" in k[NAME].lower())
