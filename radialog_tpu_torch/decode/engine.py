"""Autoregressive generation: prefill + greedy decode over the int8 cache
(port of radialog_tpu/decode/engine.py: ``generate_shared_prefix``,
``prefix_kv``, ``generate`` and ``decode_loop``, greedy only).

The JAX ``lax.while_loop`` becomes a Python loop with the same early exit:
it stops once every lane has emitted EOS. ``DecodeParams.unroll`` is kept
and is token-identical: here it is the number of steps between two checks
of that exit condition (each check waits for the card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models.llama import (KVCache, LlamaConfig, PrefixKV, find_img_start, init_cache,
                            llama_apply, prefill_bias, quantize_kv)
from ..ops.layers import DTypePolicy, FP32
from .kvcache import bucket_length


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    max_new_tokens: int = 300
    eos_token_id: int = 2
    do_sample: bool = False
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


def _select_token(logits: torch.Tensor, dp: DecodeParams) -> torch.Tensor:
    if dp.do_sample:
        raise NotImplementedError("sampling is not ported yet; greedy only")
    return torch.argmax(logits, dim=-1).to(torch.int32)


def prefix_kv(params: Dict, cfg: LlamaConfig, prefix_tokens: torch.Tensor,
              lora: Optional[Dict] = None, policy: DTypePolicy = FP32,
              img_embs: Optional[torch.Tensor] = None) -> PrefixKV:
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
                           img_embs=img_embs, img_start=img_start)
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


def generate_shared_prefix(params: Dict, cfg: LlamaConfig, prefix_tokens: torch.Tensor,
                           tokens: torch.Tensor, lengths: torch.Tensor,
                           dp: DecodeParams = DecodeParams(),
                           img_embs: Optional[torch.Tensor] = None,
                           lora: Optional[Dict] = None, policy: DTypePolicy = FP32,
                           cache_len: Optional[int] = None,
                           prefix_img_embs: Optional[torch.Tensor] = None
                           ) -> GenerationResult:
    """generate() for prompts that share a literal token prefix.

    prefix_tokens (P0,) is prefilled once; tokens (B, T1) are the per-lane
    right-padded remainders with lengths (B,) >= 1. The remainder prefill
    attends the compute-dtype prefix; the decode loop reads an int8 copy of
    it through K2's shared-prefix block, once per step for all lanes."""
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
                       img_embs=prefix_img_embs)
    cache = init_cache(cfg, b, cache_len, device=dev)
    positions = p0 + torch.arange(t1, device=dev)[None].repeat(b, 1)
    img_start = find_img_start(tokens, cfg.img_token_id) if img_embs is not None else None
    logits, cache = llama_apply(params, cfg, tokens, positions, prefill_bias(lengths, t1),
                                cache=cache, write_pos=0, img_embs=img_embs,
                                img_start=img_start, lora=lora, policy=policy,
                                lengths=lengths, last_pos=lengths - 1, shared_kv=shared)
    return decode_loop(params, cfg, cache, logits[:, 0], lengths, dp, lora=lora,
                       policy=policy, prompt_pad=t1, shared_kv=quantize_prefix(shared),
                       pos_offset=p0, shared_p0=p0)


def generate(params: Dict, cfg: LlamaConfig, tokens: torch.Tensor, lengths: torch.Tensor,
             dp: DecodeParams = DecodeParams(), img_embs: Optional[torch.Tensor] = None,
             lora: Optional[Dict] = None, policy: DTypePolicy = FP32,
             cache_len: Optional[int] = None) -> GenerationResult:
    """Prefill straight into the int8 cache, then greedy decode. (The JAX
    engine installs a small batch's prefill in a second pass; both give the
    same cache contents.)"""
    b, t = tokens.shape
    dev = tokens.device
    if cache_len is None:
        cache_len = default_cache_len(t, dp)
    if img_embs is not None and img_embs.shape[1] != cfg.num_img_tokens:
        raise ValueError(f"img_embs provides {img_embs.shape[1]} embeddings but the "
                         f"prompt contract reserves {cfg.num_img_tokens} <IMG> slots")
    cache = init_cache(cfg, b, cache_len, device=dev)
    img_start = find_img_start(tokens, cfg.img_token_id) if img_embs is not None else None
    logits, cache = llama_apply(params, cfg, tokens,
                                torch.arange(t, device=dev)[None].repeat(b, 1),
                                prefill_bias(lengths, t), cache=cache, write_pos=0,
                                img_embs=img_embs, img_start=img_start, lora=lora,
                                policy=policy, lengths=lengths, last_pos=lengths - 1)
    return decode_loop(params, cfg, cache, logits[:, 0], lengths, dp, lora=lora,
                       policy=policy, prompt_pad=t)


def decode_step(params: Dict, cfg: LlamaConfig, cache: KVCache, last_tok: torch.Tensor,
                prompt_lengths: torch.Tensor, prompt_pad: int, step: int,
                lora=None, policy: DTypePolicy = FP32, shared_kv=None,
                pos_offset: int = 0, shared_p0: Optional[int] = None) -> torch.Tensor:
    """One forward of the last tokens (B,) at decode step ``step``: writes
    their K/V at slot prompt_pad + step and returns logits (B, V)."""
    pos = (prompt_lengths + pos_offset + step)[:, None]
    logits, _ = llama_apply(params, cfg, last_tok[:, None], pos, None, cache=cache,
                            write_pos=prompt_pad + step, lora=lora, policy=policy,
                            lengths=prompt_lengths, slot_info=(prompt_pad, step),
                            shared_kv=shared_kv, shared_p0=shared_p0)
    return logits[:, 0]


def decode_loop(params: Dict, cfg: LlamaConfig, cache: KVCache, first_logits: torch.Tensor,
                prompt_lengths: torch.Tensor, dp: DecodeParams, lora=None,
                policy: DTypePolicy = FP32, prompt_pad: Optional[int] = None,
                shared_kv=None, pos_offset: int = 0,
                shared_p0: Optional[int] = None) -> GenerationResult:
    """Greedy decode with static-slot KV writes: step s writes every lane's
    K/V at slot prompt_pad + s; positions and masks stay per lane."""
    if prompt_pad is None:
        raise ValueError("decode_loop requires prompt_pad (padded prompt length)")
    b = first_logits.shape[0]
    max_new = dp.max_new_tokens
    if prompt_pad + max_new > cache.max_len:
        raise ValueError(f"cache too small: {prompt_pad}+{max_new} > {cache.max_len}")
    unroll = max(1, int(dp.unroll))
    tok = _select_token(first_logits, dp)
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
                                 pos_offset=pos_offset, shared_p0=shared_p0)
            nxt = _select_token(logits, dp)
            nxt = torch.where(done, torch.full_like(nxt, dp.eos_token_id), nxt)
            out[:, step + 1] = nxt
            done = done | (nxt == dp.eos_token_id)
            tok = nxt
            step += 1
    eos_hit = out == dp.eos_token_id
    gen_len = torch.where(eos_hit.any(dim=1), torch.argmax(eos_hit.int(), dim=1) + 1,
                          torch.full((b,), max_new, device=out.device))
    return GenerationResult(out, gen_len, prompt_lengths)
