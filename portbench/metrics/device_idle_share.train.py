"""Percent of the profiled stretch's wall time in which no operation ran
on the device: 1 minus the union of the device's operation intervals over
the stretch's length by the host's clock, averaged over the chips."""
UNIT = "%"


def read(run):
    if run is None or run.kind != "train" or not run.window_s():
        return None
    if not any(t["kernels"] for t in run.traces):
        return None
    return 100.0 * (1.0 - run.busy_s() / run.window_s())
