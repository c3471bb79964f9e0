from gogp_torch.kernels.base import Kernel, NoiseKernel  # noqa: F401
from gogp_torch.kernels import deep  # noqa: F401
from gogp_torch.kernels.multioutput import (  # noqa: F401
    icm,
    init_icm_theta,
    lmc,
    stack_tasks,
    task_inputs,
)
from gogp_torch.kernels.noise import (  # noqa: F401
    constant_noise,
    jitter_only_noise,
    uniform_noise,
)
from gogp_torch.kernels.stationary import (  # noqa: F401
    SQRT3,
    SQRT5,
    exponential,
    linear,
    matern12,
    matern32,
    matern52,
    matern52_ref,
    normal,
    periodic,
    rational_quadratic,
    rbf,
    spectral_mixture,
    white,
)
