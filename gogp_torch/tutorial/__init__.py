"""Case-study drivers: the hyperpriors study and the Bayesian forecast
driver (``python -m gogp_torch.tutorial.bayes``)."""
