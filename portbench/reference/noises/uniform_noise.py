"""The same noise on every point: t = (log sigma), variance sigma^2,
d sigma^2 / dlog sigma = 2 sigma^2."""

import torch

THETA = 1


def var(t):
    v = torch.exp(2 * t[:, 0])
    return v, [2 * v]
