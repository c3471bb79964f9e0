from gogp_torch.models.params import (  # noqa: F401
    GPParams,
    gp_observe,
    gp_posterior,
    join_params,
    make_gp_logp,
    split_params,
)
