"""K2' (per-lane intervals of the ring) share of its roofline over the
traced ring chunks: each call's live rows (k2_bound) over its kernel time."""
from benchmark.metrics._read import k2_pct as read  # noqa: F401
