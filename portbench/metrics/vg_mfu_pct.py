"""The whole value-and-gradient call's share of the card's f32 peak: the
algorithm's FLOPs a call (``work.vg_flops``, fixed by chains, n and p) over
the traced time a call times 67 TFLOP/s."""

from portbench import work

UNIT, END_TO_END = "%", False


def read(run):
    t = run.trace
    if not t or not t.vg_calls:
        return None
    return 100.0 * t.vg_flops * t.vg_calls / (t.window_s * work.F32_FLOPS_PER_S)
