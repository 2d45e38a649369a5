"""KV-cache sizing and the prefill install (port of
radialog_tpu/decode/kvcache.py ``bucket_length`` and ``install_prefill``)."""
from __future__ import annotations

from ..models.llama import KVCache, PrefixKV, quantize_kv


def bucket_length(n: int, buckets=(128, 256, 384, 512, 768, 1024, 1536, 2048)) -> int:
    """Smallest bucket >= n (then multiples of 128)."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


def install_prefill(cache: KVCache, fresh: PrefixKV, lane: int = 0) -> KVCache:
    """Copy fresh prefill K/V (L,B,T,H,D) into slots [0, T) of lanes
    [lane, lane + B) of the cache, IN PLACE (the JAX package returns a new
    cache): cast for the bf16 cache, quantized layer by layer for the int8
    one. Each layer's rounding is ``quantize_kv``, the one the direct
    prefill applies, so both leave the same bytes; the scales stay at the
    port's H lanes. The ring batcher installs one lane's prompt into a
    many-lane cache through ``lane``. Returns the same cache object."""
    num_layers, b, t, h, d = fresh.k.shape
    lanes = slice(lane, lane + b)
    if not cache.quantized:
        cache.k[:, lanes, :t] = fresh.k.to(cache.k.dtype)
        cache.v[:, lanes, :t] = fresh.v.to(cache.v.dtype)
        return cache
    for i in range(num_layers):
        k8, ks = quantize_kv(fresh.k[i])
        v8, vs = quantize_kv(fresh.v[i])
        cache.k[i, lanes, :t] = k8.reshape(b, t, h * d)
        cache.v[i, lanes, :t] = v8.reshape(b, t, h * d)
        cache.k_scale[i, lanes, :t] = ks
        cache.v_scale[i, lanes, :t] = vs
    return cache
