from gogp_torch.infer import mle  # noqa: F401
