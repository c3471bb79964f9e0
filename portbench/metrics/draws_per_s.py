"""Chains times transitions completed in the window, over its seconds (the
window holds sampling transitions only: no warm-up transition is in it)."""

UNIT, END_TO_END = "draws/s", True


def read(run):
    return run.chains * run.steps / run.window_s if run.sampler else None
