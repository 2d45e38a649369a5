"""device_idle_pct.report's reader on the float cell (its own end-to-end metric,
``float_reports_per_s``)."""
from benchmark.metrics._read import reader

read = reader("device_idle_pct.report")
