"""Utilities: checkpoint and resume (``torch.save``), profiling and phase
timing, and the native (C++) host helpers.  PyTorch twin of
``gogp_tpu/utils``."""

from gogp_torch.utils.checkpoint import restore, save
from gogp_torch.utils.profiling import PhaseTimer, count, device_trace, recording, span, timed

__all__ = ["PhaseTimer", "count", "device_trace", "recording", "restore", "save", "span", "timed"]
