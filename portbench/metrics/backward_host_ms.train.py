"""Host ms per step spent in the port's ``step/backward`` span (the
gradients' computation, autograd's dispatch of the backward graph), by
the port's host accounting (``utils.profiler.spans_on``) over the
window's steps outside the profiled stretch. None where the driver hands
no span totals or the program opens no such span. Layer: the entry
point, ``train/steps.py``."""
UNIT = "ms"
SPAN = "step/backward"


def read(run):
    if run is None or run.kind != "train":
        return None
    totals = getattr(run, "span_totals", None) or {}
    steps = totals.get("step", (0, 0))[1]
    if SPAN not in totals or not steps:
        return None
    return totals[SPAN][0] / 1e6 / steps
