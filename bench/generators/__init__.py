"""Traffic generators, one module each, named by a traffic mix's
``generator`` key (bench/harness/traffic.py)."""
