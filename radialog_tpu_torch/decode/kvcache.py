"""KV-cache sizing and the prefill install (port of
radialog_tpu/decode/kvcache.py ``bucket_length`` and ``install_prefill``
for the int8 cache)."""
from __future__ import annotations

from ..models.llama import KVCache, PrefixKV, quantize_kv


def bucket_length(n: int, buckets=(128, 256, 384, 512, 768, 1024, 1536, 2048)) -> int:
    """Smallest bucket >= n (then multiples of 128)."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


def install_prefill(cache: KVCache, fresh: PrefixKV, lane: int = 0) -> KVCache:
    """Quantize fresh prefill K/V (L,B,T,H,D) layer by layer into slots
    [0, T) of lanes [lane, lane + B) of the int8 cache, IN PLACE (the JAX
    package returns a new cache). Each layer's rounding is ``quantize_kv``,
    the one the direct prefill applies, so both leave the same bytes; the
    scales stay at the port's H lanes. Returns the same cache object."""
    num_layers, b, t, h, d = fresh.k.shape
    lanes = slice(lane, lane + b)
    for i in range(num_layers):
        k8, ks = quantize_kv(fresh.k[i])
        v8, vs = quantize_kv(fresh.v[i])
        cache.k[i, lanes, :t] = k8.reshape(b, t, h * d)
        cache.v[i, lanes, :t] = v8.reshape(b, t, h * d)
        cache.k_scale[i, lanes, :t] = ks
        cache.v_scale[i, lanes, :t] = vs
    return cache
