"""The share of the traced stretch in which no operation ran on the device:
1 less the union of its operations' intervals over the stretch."""

UNIT, END_TO_END = "%", False


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t and t.window_s > 0 else None
