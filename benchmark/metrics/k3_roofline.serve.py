"""K3's share of its roofline in the ring's admissions of 256 rows or more
over the traced stretch: k3_bound of each launch recorded there (its
shape and lengths) over K3's kernel time in the profiler's records."""
from benchmark.metrics._read import k3_pct as read  # noqa: F401
