"""Percent of the cards' bf16 peak (989 TFLOP/s dense a card) that the
training window reached outside the profiled stretch: the model FLOPs of
a step's pairs (forward x 3 for the trained fusion net, x 2 for the
frozen seg net, x 1 for the guide's taps; recomputation not counted)
times the pairs completed, over the seconds and the chips."""
from portbench.yardstick.roofline import BF16_PEAK_FLOPS

UNIT = "%"


def read(run):
    if run is None or run.kind != "train" or run.seconds_outside <= 0:
        return None
    if not run.pairs_outside:
        return None
    rate = run.pairs_outside * run.flops_per_pair / run.seconds_outside
    return 100.0 * rate / (BF16_PEAK_FLOPS * run.chips)
