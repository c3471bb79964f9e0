"""The window's milliseconds over the value-and-gradient calls completed in
it; a call over the whole chain batch counts once."""

UNIT, END_TO_END = "ms", True


def read(run):
    return 1e3 * run.window_s / run.vg_calls if run.vg_calls else None
