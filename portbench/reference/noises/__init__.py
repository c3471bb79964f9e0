"""Plain noise models, one module each, named as a configuration's
``noise`` (as ``kernels/`` are).  Each gives ``THETA`` and ``var(t) ->
(the variance added to K's diagonal, [its derivative in each t_j])`` for t
(batch, THETA), each (batch,)."""
