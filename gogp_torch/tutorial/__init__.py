"""Case-study drivers: the rolling-forecast driver (``evaluate``) with the
five studies (``python -m gogp_torch.tutorial.<study> selfcheck``), their
runner (``python -m gogp_torch.tutorial.selfcheck``), and the Bayesian
forecast driver (``python -m gogp_torch.tutorial.bayes``)."""
