"""Device kernels (copies left out) a value-and-gradient call, from the
trace of the traced stretch."""

UNIT, END_TO_END = "launches", False


def read(run):
    t = run.trace
    return t.device_launches / t.vg_calls if t and t.vg_calls else None
