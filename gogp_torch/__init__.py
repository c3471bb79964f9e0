"""gogp_torch: the PyTorch and CUDA port of gogp_tpu, for NVIDIA Hopper.

Module layout mirrors ``gogp_tpu/`` one for one; each module names its JAX
twin, against which the tests hold it.

- ``gogp_torch.kernels`` - pair-function kernels and combinators, deep
  kernels (``deep``) and multi-output coregionalization (``multioutput``).
- ``gogp_torch.gp``      - covariance assembly, LML, prediction; serving
  caches (``serve``), streaming appends (``streaming``), exact LOO
  (``model_selection``), non-Gaussian likelihoods (``likelihoods``)
  with the Laplace (``laplace``) and EP (``ep``) approximations, sparse
  GPs (``sparse``: SGPR, SVGP, natural gradients) and the Student-t
  process (``tprocess``), pathwise posterior sampling (``pathwise``:
  random-feature priors conditioned by Matheron's rule).
- ``gogp_torch.bo``      - Bayesian optimization on the streaming posterior
  (EI, UCB, exact and pathwise Thompson, batch Thompson).
- ``gogp_torch.search``  - greedy compositional kernel-structure search, each
  candidate's restarts one batched fit (K7 on the card).
- ``gogp_torch.models``  - the flat parameter-vector protocol, log-density
  composition and gradient masks.
- ``gogp_torch.dists``   - prior log-densities.
- ``gogp_torch.infer``   - maximum-likelihood fits (``mle.adam``,
  ``mle.lbfgs``, and batched over rows ``mle.adam_batched``,
  ``mle.lbfgs_batched``); ChEES-HMC (``chees``) with its warmup adaptation
  (``adapt``), integrator (``hmc``) and diagnostics (``diagnostics``).
- ``gogp_torch.infer.elliptical`` - elliptical slice sampling of the exact
  latent posterior.
- ``gogp_torch.ops``     - the linear-algebra front door (``linalg``), the
  blocked driver with its hand-written CUDA kernels (``cholesky_blocked``),
  and a chain population's small-GP value and gradient (``fused_gp``, K7);
  sources in ``gogp_torch/csrc/``.
- ``gogp_torch.tutorial`` - the rolling forecast (``evaluate``, the
  reference's entry point) with its five studies
  (``python -m gogp_torch.tutorial.<study> selfcheck``), the Bayesian
  forecast command line (``python -m gogp_torch.tutorial.bayes``) and GP
  classification (``python -m gogp_torch.tutorial.classify``).
- ``gogp_torch.convert`` - state carried across from the JAX package.

The package never imports JAX.
"""

__version__ = "0.1.0"

from gogp_torch import dists  # noqa: F401
from gogp_torch.gp.core import GP  # noqa: F401
from gogp_torch.infer import mle  # noqa: F401
from gogp_torch.kernels import (  # noqa: F401
    constant_noise,
    matern32,
    matern52,
    matern52_ref,
    normal,
    periodic,
    rbf,
    uniform_noise,
)
from gogp_torch.models import make_gp_logp, masked_value_and_grad  # noqa: F401
