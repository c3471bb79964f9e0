"""Plain covariances, one module a kernel, named as a configuration's
``kernel`` with each run of other characters than letters, digits and
``_`` made one ``_``.  Each gives ``THETA`` (its log-parameters) and
``rows(x, r0, r1, t) -> (K_f[r0:r1], [dK_f[r0:r1] / dt_j for each j])``
for x (n, d) and t (batch, THETA)."""
