"""The benchmark of gogp_torch on the card: ``python3 portbench/run.py``."""
