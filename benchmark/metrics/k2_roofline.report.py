"""K2's share of its roofline over the traced decode steps: each call's
live rows and shared prefix (k2_bound) over K2's kernel time."""
from benchmark.metrics._read import k2_pct as read  # noqa: F401
