"""Process start to the window's first step: imports, the kernels' load (or
build), the data, the warm start and the warm-up calls."""

UNIT, END_TO_END = "s", True


def read(run):
    return run.setup_s
