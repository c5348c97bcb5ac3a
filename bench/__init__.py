"""The port's benchmark harness (see bench/run.py)."""
