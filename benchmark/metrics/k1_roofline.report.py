"""K1's share of its roofline over the traced decode steps: the bounds of
the recorded calls (benchmark/roofline.py k1_bound) over K1's kernel time."""
from benchmark.metrics._read import k1_pct as read  # noqa: F401
