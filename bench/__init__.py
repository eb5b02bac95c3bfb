"""The benchmark of ``repro_torch`` on one H100 (see bench/run.py)."""
