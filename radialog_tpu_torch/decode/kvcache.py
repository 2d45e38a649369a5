"""KV-cache sizing (port of radialog_tpu/decode/kvcache.py ``bucket_length``)."""
from __future__ import annotations


def bucket_length(n: int, buckets=(128, 256, 384, 512, 768, 1024, 1536, 2048)) -> int:
    """Smallest bucket >= n (then multiples of 128)."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128
