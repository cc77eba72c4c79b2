"""Share of their roofline that the 2D smoother kernels reach: the least
time of their launches in the traced steps (the frozen ``min_bytes`` of
each launch's boxes and box size, at the card's 3.35 TB/s) over the
device time their kernels took in the trace, in %."""

from harness.roofline import share_pct


def read(rec):
    k = rec["device"]["kernels"]["2d"]
    return share_pct(k["launches"], k["seconds"])
