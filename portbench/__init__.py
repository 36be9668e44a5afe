"""The port's benchmark: one cell a run (see run.py)."""
