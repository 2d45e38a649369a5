"""The served window's share of the card's peak: the model operations of
every request's prefill and decode rows (drivers/serve.py model_flops) over
the window's seconds, its drain included, over the int8 peak (1,979 TOP/s)
of the W8A8 path."""
from benchmark.metrics._read import window_mfu as read  # noqa: F401
