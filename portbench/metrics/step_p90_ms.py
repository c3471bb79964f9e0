"""The 90th percentile of the window's steps (a fit step, or a transition),
each timed on the device's clock between the CUDA events that mark where
steps begin."""

import statistics

UNIT, END_TO_END = "ms", True


def read(run):
    if len(run.step_ms) < 2:
        return None
    return statistics.quantiles(run.step_ms, n=10, method="inclusive")[8]
