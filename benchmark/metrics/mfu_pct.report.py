"""The whole pass's share of the card's peak: the model operations of the
window's passes (benchmark/roofline.py: the LLM's prefill and decode rows
with their attention, the image side) over the window's seconds, over the
dense peak of the configuration's precision (int8 1,979 TOP/s for W8A8,
bf16 989 TFLOP/s)."""
from benchmark.metrics._read import window_mfu as read  # noqa: F401
