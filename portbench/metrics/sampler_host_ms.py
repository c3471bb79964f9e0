"""Host time a transition outside its value-and-gradient calls: the traced
stretch's host time less its calls' host time, over its transitions."""

UNIT, END_TO_END = "ms", False


def read(run):
    t = run.trace
    if not run.sampler or not t or not t.steps:
        return None
    return 1e3 * (t.window_s - t.host_vg_s) / t.steps
