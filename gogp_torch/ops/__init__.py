from gogp_torch.ops import cholesky_blocked, linalg  # noqa: F401
