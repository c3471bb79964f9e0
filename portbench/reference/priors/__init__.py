"""Plain priors, one module a family, named as a configuration's
``prior.family``.  Each gives ``log_density(v, *args) -> (the log-density
summed over v's last axis, its gradient, the gradient's scale)``."""
