"""One reader a metric, found by its name.  Each module gives ``UNIT``,
``END_TO_END`` (reported by ``--trace 0`` runs, else by ``--trace 1``) and
``read(run)``, which returns the metric's value from a
:class:`portbench.run.RunRecord`, or None where the run holds nothing it
can read (then the line leaves the metric out)."""
