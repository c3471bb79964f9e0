"""Case-study description for the tutorial drivers.

PyTorch-package twin of ``gogp_tpu/tutorial/evaluate.py``, for now only its
:class:`Study`.  The rolling one-step forecast driver (``evaluate``,
``run_cli``: the reference's ``Evaluate``, a batched fit over every prefix of
the data) is not ported yet and waits in ROADMAP.md, queue 1, item 8.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from gogp_torch.gp.core import GP

# Log-density of priors given the parameter vector (chain axis leading) and
# the 0/1 observation mask.
PriorsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class Study:
    """A case study: GP spec, optional priors, optional constraints.

    ``make_priors(X0, Y0)`` closes over the initial (normalized) data.
    ``free_fn(n_theta, n, end)`` returns the study's 0/1 free mask over the
    full parameter vector for prefix length ``end``.  ``optinp``: the inputs
    and outputs are parameters too (the latent-input studies).
    """

    name: str
    gp: GP
    optinp: bool = False
    make_priors: Callable[[np.ndarray, np.ndarray], PriorsFn] | None = None
    free_fn: Callable[[int, int, int], np.ndarray] | None = None
