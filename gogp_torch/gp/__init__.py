from gogp_torch.gp.core import (  # noqa: F401
    GP,
    Posterior,
    absorb,
    lml,
    lml_from_posterior,
    masked_cov,
    predict,
    predict_from_posterior,
    predict_mixture,
    predict_prior,
    predict_y_from_posterior,
)
