"""Autoregressive generation: prefill + decode over the int8 or the bf16
KV cache, greedy or sampled (port of radialog_tpu/decode/engine.py:
``prefill``, ``generate_shared_prefix``, ``prefix_kv``, ``generate``,
``generate_two_phase``, ``decode_loop`` and ``_select_token``).

The JAX ``lax.while_loop`` becomes a Python loop with the same early exit:
it stops once every lane has emitted EOS. ``DecodeParams.unroll`` is kept
and is token-identical: here it is the number of steps between two checks
of that exit condition (each check waits for the card).

``kv_int8`` defaults to True here, the reverse of the JAX engine's default
(as ``init_cache``'s): the port's serving default is the int8 cache, and the
pipeline passes its own setting (``PipelineConfig.use_kv_int8``) explicitly.
The stacked float params (the float path) take ``kv_int8=False``: their
prefill runs without a cache and installs it, and each decode step writes
its row and attends the whole bf16 cache under the static-slot bias; with
the int8 cache their first decode step raises, as in the JAX engine.

Sampling draws its noise from one ``torch.Generator`` per ``decode_loop``,
seeded from ``DecodeParams.seed`` on the logits' device, through
``gumbel_noise``. It gives other numbers than ``jax.random`` from the same
seed; the tests feed both the same noise by replacing ``gumbel_noise``.

``tp_group`` (the JAX engine's ``axis_name``): each rank runs these
functions over its tensor-parallel shard of the serving params and
``shard_config``'s local counts, and ``llama_apply`` sums the row-parallel
partials over the group (parallel/tp_serving.py). The logits are the same
on every rank of the group, so every rank picks the same tokens and runs
the same number of steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models.llama import (KVCache, LlamaConfig, PrefixKV, decode_bias_static_slot,
                            find_img_start, init_cache, llama_apply, prefill_bias, quantize_kv)
from ..ops.attention import NEG_INF
from ..ops.layers import DTypePolicy, FP32, div_scalar
from .kvcache import bucket_length, install_prefill

# at this batch and above the prompt is prefilled straight into the int8
# cache; below it, without a cache and then installed. The value is the
# JAX engine's, copied so that both take the same path at every batch; it
# was not tuned for this port (tools/time_prefill_paths.py times both
# paths on the card)
DIRECT_PREFILL_MIN_BATCH = 30


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    max_new_tokens: int = 300
    eos_token_id: int = 2
    temperature: float = 1.0
    do_sample: bool = False
    top_k: int = 0                   # 0: no top-k filter
    top_p: float = 1.0               # 1.0: no nucleus filter
    seed: int = 42
    unroll: int = 1


class GenerationResult(NamedTuple):
    tokens: torch.Tensor          # (B, max_new) generated ids, eos-padded
    lengths: torch.Tensor         # (B,) generated tokens incl. eos
    prompt_lengths: torch.Tensor


def default_cache_len(t: int, dp: DecodeParams) -> int:
    """Bucketed cache length for a t-token prompt, with the JAX engine's
    headroom for unroll > 2 (kept so both size the cache alike)."""
    return bucket_length(t + dp.max_new_tokens + max(0, dp.unroll - 2))


def gumbel_noise(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise in f32 by jax.random.gumbel's formula:
    -log(-log(u)) with u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def sampling_logits(logits: torch.Tensor, dp: DecodeParams) -> torch.Tensor:
    """The logits sampling draws from, as the JAX engine filters them:
    divided by the temperature (an IEEE division, ``div_scalar``: CUDA's
    division by a Python scalar multiplies by its reciprocal, which rounds
    apart from the CPU's and JAX's), then the top-k filter, then the nucleus
    filter (it keeps the tokens whose preceding mass in descending order is
    < top_p, so the first always stays); what is filtered out is NEG_INF.
    (B, V) -> (B, V) f32."""
    logits = div_scalar(logits.float(), max(dp.temperature, 1e-6))
    if dp.top_k and dp.top_k > 0:
        kth = torch.topk(logits, dp.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if dp.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < dp.top_p
        cutoff = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    return logits


def _select_token(logits: torch.Tensor, dp: DecodeParams,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy, or sampling as the JAX engine samples: argmax of
    ``sampling_logits`` plus Gumbel noise, which is what
    jax.random.categorical computes. (B, V) -> (B,) int32, on the device."""
    if not dp.do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = sampling_logits(logits, dp)
    noise = gumbel_noise(logits.shape, gen, logits.device)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def prefills_directly(params: Dict, batch: int, kv_int8: bool) -> bool:
    """Whether ``prefill`` writes a batch's prompt straight into the cache
    (the unrolled serving layout: always with the bf16 cache, from
    DIRECT_PREFILL_MIN_BATCH lanes with the int8 one) rather than prefill
    without a cache and install (the stacked layout, always)."""
    return (isinstance(params["layers"], (list, tuple))
            and (not kv_int8 or batch >= DIRECT_PREFILL_MIN_BATCH))


def prefill(params: Dict, cfg: LlamaConfig, tokens: torch.Tensor, lengths: torch.Tensor,
            cache_len: int, img_embs: Optional[torch.Tensor] = None,
            lora: Optional[Dict] = None, policy: DTypePolicy = FP32, kv_int8: bool = True,
            tp_group=None):
    """The prompt pass: returns (cache, last_logits (B, V)). tokens (B, T)
    right-padded with lengths (B,); cache_len >= T + max_new.

    With the int8 cache (``kv_int8``), at batch >= DIRECT_PREFILL_MIN_BATCH
    each layer quantizes its K/V straight into the cache. Below it the
    prefill runs without a cache (flash attention, K3, at T >= 256) and
    ``install_prefill`` quantizes the fresh K/V into the cache afterwards, as
    the JAX engine does. Below 256 tokens both paths leave the same cache
    bytes and logits. The bf16 cache is always prefilled directly on the
    unrolled serving layout, as in the JAX engine. The stacked layout (the
    float path) always prefills without a cache and installs: its prefill
    attends the compute-dtype K/V, rounded to the cache's dtype only at the
    install."""
    b, t = tokens.shape
    dev = tokens.device
    if img_embs is not None and img_embs.shape[1] != cfg.num_img_tokens:
        raise ValueError(f"img_embs provides {img_embs.shape[1]} embeddings but the "
                         f"prompt contract reserves {cfg.num_img_tokens} <IMG> slots")
    positions = torch.arange(t, device=dev)[None].repeat(b, 1)
    img_start = find_img_start(tokens, cfg.img_token_id) if img_embs is not None else None
    cache = init_cache(cfg, b, cache_len, device=dev, quantized=kv_int8)
    direct = prefills_directly(params, b, kv_int8)
    logits, out = llama_apply(params, cfg, tokens, positions, prefill_bias(lengths, t),
                              cache=cache if direct else None, write_pos=0,
                              img_embs=img_embs, img_start=img_start, lora=lora,
                              policy=policy, lengths=lengths, last_pos=lengths - 1,
                              tp_group=tp_group)
    if not direct:
        cache = install_prefill(cache, out)
    return cache, logits[:, 0]


def prefix_kv(params: Dict, cfg: LlamaConfig, prefix_tokens: torch.Tensor,
              lora: Optional[Dict] = None, policy: DTypePolicy = FP32,
              img_embs: Optional[torch.Tensor] = None, tp_group=None) -> PrefixKV:
    """Prefill a batch-wide shared prefix (P0,) once: per-layer K/V
    (L, P0, H, D) in the compute dtype."""
    p0 = prefix_tokens.shape[0]
    dev = prefix_tokens.device
    ln = torch.full((1,), p0, dtype=torch.int32, device=dev)
    img_start = (find_img_start(prefix_tokens[None], cfg.img_token_id)
                 if img_embs is not None else None)
    _, fresh = llama_apply(params, cfg, prefix_tokens[None],
                           torch.arange(p0, device=dev)[None], prefill_bias(ln, p0),
                           lora=lora, policy=policy, lengths=ln,
                           last_pos=torch.zeros((1,), dtype=torch.int32, device=dev),
                           img_embs=img_embs, img_start=img_start, tp_group=tp_group)
    return PrefixKV(fresh.k[:, 0], fresh.v[:, 0])


def quantize_prefix(shared: PrefixKV, rows: int = 32):
    """Per-layer int8 prefix for decode: (k0, ks0, v0, vs0) with k0/v0
    (P0p, H*D) int8 and scales (P0p, H) bf16, rows padded with zeros to a
    multiple of ``rows`` (the JAX package's 32-row padding, so both walk
    the same prefix block)."""
    L, P0, H, D = shared.k.shape
    p0p = -(-P0 // rows) * rows
    k8, ks = quantize_kv(shared.k)
    v8, vs = quantize_kv(shared.v)
    pad = (0, 0, 0, p0p - P0)
    k0 = F.pad(k8.reshape(L, P0, H * D), pad)
    v0 = F.pad(v8.reshape(L, P0, H * D), pad)
    ks0 = F.pad(ks, pad)
    vs0 = F.pad(vs, pad)
    return [(k0[i], ks0[i], v0[i], vs0[i]) for i in range(L)]


def decode_prefix(shared: PrefixKV, cache: KVCache):
    """The decode loop's per-layer copy of a shared prefix, in the cache's
    dtype: ``quantize_prefix``'s int8 tuples, or (k0, v0) pairs (P0, H, D)
    for the bf16 cache."""
    if cache.quantized:
        return quantize_prefix(shared)
    k0, v0 = shared.k.to(cache.k.dtype), shared.v.to(cache.v.dtype)
    return [(k0[i], v0[i]) for i in range(k0.shape[0])]


def generate_shared_prefix(params: Dict, cfg: LlamaConfig, prefix_tokens: torch.Tensor,
                           tokens: torch.Tensor, lengths: torch.Tensor,
                           dp: DecodeParams = DecodeParams(),
                           img_embs: Optional[torch.Tensor] = None,
                           lora: Optional[Dict] = None, policy: DTypePolicy = FP32,
                           cache_len: Optional[int] = None,
                           prefix_img_embs: Optional[torch.Tensor] = None,
                           kv_int8: bool = True, tp_group=None) -> GenerationResult:
    """generate() for prompts that share a literal token prefix.

    prefix_tokens (P0,) is prefilled once; tokens (B, T1) are the per-lane
    right-padded remainders with lengths (B,) >= 1. The remainder prefill
    attends the compute-dtype prefix; the decode loop reads a copy of it in
    the cache's dtype, once per step for all lanes: int8 through K2's
    shared-prefix block, bf16 merged with the lane's rows in one softmax.
    Unrolled serving layout only, as in the JAX engine."""
    if not isinstance(params["layers"], (list, tuple)):
        raise ValueError("prefix sharing is a serving feature of the unrolled weight "
                         "layout (ops/quant.quantize_llama_host)")
    b, t1 = tokens.shape
    p0 = prefix_tokens.shape[0]
    dev = tokens.device
    if cache_len is None:
        cache_len = default_cache_len(t1, dp)
    if img_embs is not None and img_embs.shape[1] != cfg.num_img_tokens:
        raise ValueError(f"img_embs provides {img_embs.shape[1]} embeddings but the "
                         f"prompt contract reserves {cfg.num_img_tokens} <IMG> slots")
    if prefix_img_embs is not None and prefix_img_embs.shape[1] != cfg.num_img_tokens:
        raise ValueError(f"prefix_img_embs provides {prefix_img_embs.shape[1]} embeddings "
                         f"but the prompt contract reserves {cfg.num_img_tokens}")
    shared = prefix_kv(params, cfg, prefix_tokens, lora=lora, policy=policy,
                       img_embs=prefix_img_embs, tp_group=tp_group)
    cache = init_cache(cfg, b, cache_len, device=dev, quantized=kv_int8)
    positions = p0 + torch.arange(t1, device=dev)[None].repeat(b, 1)
    img_start = find_img_start(tokens, cfg.img_token_id) if img_embs is not None else None
    logits, cache = llama_apply(params, cfg, tokens, positions, prefill_bias(lengths, t1),
                                cache=cache, write_pos=0, img_embs=img_embs,
                                img_start=img_start, lora=lora, policy=policy,
                                lengths=lengths, last_pos=lengths - 1, shared_kv=shared,
                                tp_group=tp_group)
    return decode_loop(params, cfg, cache, logits[:, 0], lengths, dp, lora=lora,
                       policy=policy, prompt_pad=t1, shared_kv=decode_prefix(shared, cache),
                       pos_offset=p0, shared_p0=p0, tp_group=tp_group)


def generate(params: Dict, cfg: LlamaConfig, tokens: torch.Tensor, lengths: torch.Tensor,
             dp: DecodeParams = DecodeParams(), img_embs: Optional[torch.Tensor] = None,
             lora: Optional[Dict] = None, policy: DTypePolicy = FP32,
             cache_len: Optional[int] = None, kv_int8: bool = True,
             tp_group=None) -> GenerationResult:
    """``prefill``, then decode."""
    if cache_len is None:
        cache_len = default_cache_len(tokens.shape[1], dp)
    cache, first = prefill(params, cfg, tokens, lengths, cache_len, img_embs=img_embs,
                           lora=lora, policy=policy, kv_int8=kv_int8, tp_group=tp_group)
    return decode_loop(params, cfg, cache, first, lengths, dp, lora=lora, policy=policy,
                       prompt_pad=tokens.shape[1], tp_group=tp_group)


# JAX's generate_two_phase dispatches the prefill and the decode as two jitted
# programs with the cache donated between them. Here every call is dispatched
# apart and the decode writes the prefill's cache in place, which is what
# generate runs: the same function.
generate_two_phase = generate


def decode_step(params: Dict, cfg: LlamaConfig, cache: KVCache, last_tok: torch.Tensor,
                prompt_lengths: torch.Tensor, prompt_pad: int, step: int,
                lora=None, policy: DTypePolicy = FP32, shared_kv=None,
                pos_offset: int = 0, shared_p0: Optional[int] = None,
                defer_kv: Optional[bool] = None, tp_group=None) -> torch.Tensor:
    """One forward of the last tokens (B,) at decode step ``step``: writes
    their K/V at slot prompt_pad + step and returns logits (B, V). The bf16
    cache is masked by ``decode_bias_static_slot``; ``defer_kv`` is
    ``llama_apply``'s (None reads RADIALOG_DEFER_KV)."""
    pos = (prompt_lengths + pos_offset + step)[:, None]
    bias = None if cache.quantized else decode_bias_static_slot(
        prompt_lengths, prompt_pad, step, cache.max_len)
    logits, _ = llama_apply(params, cfg, last_tok[:, None], pos, bias, cache=cache,
                            write_pos=prompt_pad + step, lora=lora, policy=policy,
                            lengths=prompt_lengths, slot_info=(prompt_pad, step),
                            shared_kv=shared_kv, shared_p0=shared_p0, defer_kv=defer_kv,
                            tp_group=tp_group)
    return logits[:, 0]


def decode_loop(params: Dict, cfg: LlamaConfig, cache: KVCache, first_logits: torch.Tensor,
                prompt_lengths: torch.Tensor, dp: DecodeParams, lora=None,
                policy: DTypePolicy = FP32, prompt_pad: Optional[int] = None,
                shared_kv=None, pos_offset: int = 0,
                shared_p0: Optional[int] = None, tp_group=None) -> GenerationResult:
    """Greedy or sampled decode with static-slot KV writes: step s writes
    every lane's K/V at slot prompt_pad + s; positions and masks stay per
    lane. A lane that emitted EOS keeps emitting it.

    The cache is written in place, so this is also the JAX package's
    ``_decode_loop_with_cache`` (the decode that hands the cache back):
    the interactive session (decode/session.py) calls it with
    prompt_lengths = prompt_pad = its current length and keeps its cache."""
    if prompt_pad is None:
        raise ValueError("decode_loop requires prompt_pad (padded prompt length)")
    b = first_logits.shape[0]
    max_new = dp.max_new_tokens
    if prompt_pad + max_new > cache.max_len:
        raise ValueError(f"cache too small: {prompt_pad}+{max_new} > {cache.max_len}")
    unroll = max(1, int(dp.unroll))
    gen = (torch.Generator(device=first_logits.device).manual_seed(dp.seed)
           if dp.do_sample else None)
    tok = _select_token(first_logits, dp, gen)
    out = torch.full((b, max_new), dp.eos_token_id, dtype=torch.int32,
                     device=first_logits.device)
    out[:, 0] = tok
    done = tok == dp.eos_token_id
    step = 0
    while step + 1 < max_new and not bool(done.all()):
        for _ in range(unroll):
            if step + 1 >= max_new:
                break
            logits = decode_step(params, cfg, cache, tok, prompt_lengths, prompt_pad, step,
                                 lora=lora, policy=policy, shared_kv=shared_kv,
                                 pos_offset=pos_offset, shared_p0=shared_p0,
                                 tp_group=tp_group)
            nxt = _select_token(logits, dp, gen)
            nxt = torch.where(done, torch.full_like(nxt, dp.eos_token_id), nxt)
            out[:, step + 1] = nxt
            done = done | (nxt == dp.eos_token_id)
            tok = nxt
            step += 1
    eos_hit = out == dp.eos_token_id
    gen_len = torch.where(eos_hit.any(dim=1), torch.argmax(eos_hit.int(), dim=1) + 1,
                          torch.full((b,), max_new, device=out.device))
    return GenerationResult(out, gen_len, prompt_lengths)
