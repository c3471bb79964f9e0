"""A kernel's share of its roofline, for the kernel readers."""

import sys


def roofline_pct(run, kernel: str):
    row = run.trace.kernels.get(kernel) if run.trace else None
    if not row or not row["events"]:
        return None
    if row["events"] != row["launches"]:
        print(f"portbench: {kernel}: {row['events']} device events against {row['launches']} launches",
              file=sys.stderr)
        return None
    return 100.0 * row["bound_s"] / row["device_s"]
