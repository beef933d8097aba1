"""Percent: the sum over the profiled stretch's ``segmif::`` calls of
each call's bound (the yardstick's roofline arithmetic on the call's
recorded shapes) over the sum of their device times. Layer: the kernels,
``kernels/csrc/*.cu``."""
from portbench.trace import roofline_share

UNIT = "%"


def read(run):
    if run is None or run.kind != "serve":
        return None
    return roofline_share(run.traces)
