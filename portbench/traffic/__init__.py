"""Traffic: one generator module a kind (``fit.py``, ``chees.py``) and one
mix file a cell's traffic (``<traffic>.json``, whose ``kind`` names its
generator)."""
