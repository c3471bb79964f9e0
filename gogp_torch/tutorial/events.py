"""Case study: event-discounted similarity kernel.

PyTorch-package twin of ``gogp_tpu/tutorial/events.py`` (reference
tutorial/events): the similarity of two points is scaled down by an event's
discount factor when the pair straddles the event's boundary, the first
matching event winning (events/kernel/kernel.go:36-44).  The events are
fixed data closed over by the kernel.

Run:  python -m gogp_torch.tutorial.events [flags] selfcheck
Flags: --events "from:to:discount,..." (e.g. "1.:2.5:0.3,3:6:0.5").
"""

from __future__ import annotations

from importlib import resources

import torch

from gogp_torch.gp.core import GP
from gogp_torch.kernels import Kernel, matern52_ref, uniform_noise
from gogp_torch.tutorial.evaluate import Study, run_cli


def events_kernel(events: list[tuple[float, float, float]]) -> Kernel:
    """Scaled Matérn-5/2 with event-boundary discounting.

    ``events`` is a list of (from, to, discount).  The reference applies only
    the first matching event (events/kernel/kernel.go:41-44): here a
    first-match mask and ``torch.where``, one per event."""
    base = matern52_ref.scaled()

    def pair(theta, xa, xb):
        k = base.pair(theta, xa, xb)
        lo = torch.minimum(xa[..., 0], xb[..., 0])
        hi = torch.maximum(xa[..., 0], xb[..., 0])
        matched = torch.zeros(k.shape, dtype=torch.bool, device=k.device)
        for frm, to, discount in events:
            crosses = ((lo < frm) & (frm <= hi)) | ((lo < to) & (to <= hi))
            k = torch.where(crosses & ~matched, k * discount, k)
            matched = matched | crosses
        return k

    return Kernel(base.n_theta, pair, f"events({len(events)})")


def parse_events(spec: str) -> list[tuple[float, float, float]]:
    """Parse "from:to:discount,..." (reference events/main.go:52-64)."""
    if not spec:
        return []
    out = []
    for ev in spec.split(","):
        parts = [float(s) for s in ev.split(":")]
        if len(parts) != 3:
            raise ValueError(f"bad event {ev!r}: want from:to:discount")
        out.append(tuple(parts))
    return out


def make_study(events: list[tuple[float, float, float]] | None = None) -> Study:
    return Study(
        name="events",
        gp=GP(ndim=1, simil=events_kernel(events or []), noise=uniform_noise.scaled_by(0.01)),
    )


def selfcheck_data() -> str:
    return resources.files("gogp_torch.tutorial").joinpath("data/regimes.csv").read_text()


def _extra_flags(ap):
    # "-events" alias: the reference CLI's Go-style single-dash long flag
    ap.add_argument("--events", "-events", default="",
                    help='comma separated colon connected event list "from:to:discount,..."')


def main(argv=None):
    return run_cli(
        lambda a: make_study(parse_events(a.events)),
        selfcheck_data(),
        "GP with event-discounted similarity kernel.",
        extra_flags=_extra_flags,
        argv=argv,
    )


if __name__ == "__main__":
    main()
