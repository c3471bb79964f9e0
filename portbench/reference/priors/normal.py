"""An independent N(mu, sigma) on each entry of v."""

import math


def log_density(v, mu, sigma):
    z = (v - mu) / sigma
    val = (-0.5 * z * z - 0.5 * math.log(2 * math.pi) - math.log(sigma)).sum(-1)
    g = -z / sigma
    return val, g, g.abs()
