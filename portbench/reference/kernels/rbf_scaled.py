"""The scaled squared exponential: t = (log s, log l),

    K_f = s exp(-|x_i - x_j|^2 / (2 l^2)),
    dK_f/dlog s = K_f,  dK_f/dlog l = K_f |x_i - x_j|^2 / l^2."""

import torch

THETA = 2


def rows(x, r0, r1, t):
    s, l = (torch.exp(t[:, j])[:, None, None] for j in range(2))
    d2 = ((x[r0:r1, None, :] - x[None, :, :]) ** 2).sum(-1)
    kf = s * torch.exp(-d2 / (2 * l * l))
    return kf, [kf, kf * d2 / (l * l)]
