"""Device time of library kernels (cuBLAS, cuSOLVER: neither the port's nor
PyTorch's own) a value-and-gradient call, over the traced stretch."""

UNIT, END_TO_END = "ms", False


def read(run):
    t = run.trace
    return 1e3 * t.library_s / t.vg_calls if t and t.vg_calls else None
