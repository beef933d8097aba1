"""Percent of the card's bf16 peak (989 TFLOP/s dense) that the serving
window reached outside the profiled stretch: the model FLOPs of a pair
(the yardstick's count of the configuration's shapes) times the pairs
completed, over the seconds, by the host's clock."""
from portbench.yardstick.roofline import BF16_PEAK_FLOPS

UNIT = "%"


def read(run):
    if run is None or run.kind != "serve" or run.seconds_outside <= 0:
        return None
    if not run.pairs_outside:
        return None
    rate = run.pairs_outside * run.flops_per_pair / run.seconds_outside
    return 100.0 * rate / (BF16_PEAK_FLOPS * run.chips)
