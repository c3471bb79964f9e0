"""Utilities: checkpoint and resume (``torch.save``), profiling and phase
timing, and the native (C++) host helpers.  PyTorch twin of
``gogp_tpu/utils``."""

from gogp_torch.utils.checkpoint import restore, save
from gogp_torch.utils.profiling import PhaseTimer, device_trace, timed

__all__ = ["PhaseTimer", "device_trace", "restore", "save", "timed"]
