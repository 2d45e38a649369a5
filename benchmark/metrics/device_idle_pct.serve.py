"""The share of the traced stretch with no operation running on the
device: 1 - busy / window, busy the union of the kernels' intervals."""
from benchmark.metrics._read import idle_pct as read  # noqa: F401
