"""K2's share of its roofline over the traced stretch: the least time its
launches need at their shapes (work.bound_s) over its device time."""

from portbench.metrics import _kernel

UNIT, END_TO_END = "%", False


def read(run):
    return _kernel.roofline_pct(run, "K2")
