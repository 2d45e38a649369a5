"""Prompt-lookup speculative decoding for one sequence (port of
radialog_tpu/decode/speculative.py: ``SpecResult``, ``ngram_propose``,
``spec_decode_loop`` and ``generate_spec``).

Each iteration drafts k tokens by continuing the most recent earlier
occurrence of the last m history tokens, runs ONE (k+1)-token verify forward
(``llama_apply(verify=True)``) against the cache, accepts the longest prefix
of drafts equal to the model's own greedy argmax and takes the model's token
at the first mismatch as a bonus. Every emitted token is the model's greedy
choice given its full context, so the tokens are ``generate``'s, up to the
float order of a (k+1)-row forward against a 1-row one, which can flip an
argmax decided by an ulp (on random weights, whose logits nearly tie, long
generations can part).

Batch 1, as in JAX: the cache slot is the token's position, the block is
written at its base slot and the slots past the accepted count are
overwritten by the next block before anything attends them. The JAX
``lax.while_loop`` is a host loop here, with one read of the emitted count
from the device per verify (and one of the first token); the cache is
written in place.

``jax.lax.dynamic_slice`` and ``dynamic_update_slice`` clamp their start
into range where Python slicing would wrap a negative start; ``ngram_propose``
and the history writes clamp as they do.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.llama import KVCache, LlamaConfig, llama_apply
from ..ops.attention import causal_mask_bias
from ..ops.layers import DTypePolicy, FP32
from .engine import DecodeParams, prefill
from .kvcache import bucket_length


class SpecResult(NamedTuple):
    tokens: torch.Tensor          # (1, max_new) generated ids, eos-padded
    lengths: torch.Tensor         # (1,) generated length incl. eos
    prompt_lengths: torch.Tensor
    iters: int                    # verify forwards run; mean accepted = lengths / iters


def ngram_propose(hist: torch.Tensor, hist_len, k: int, m: int) -> torch.Tensor:
    """Draft ``k`` tokens continuing the most recent earlier occurrence of
    the last ``m`` history tokens; with no match, the last token k times.

    hist (Hmax,) int32 with live length ``hist_len`` (an int or a 0-d
    tensor), or a batch: hist (B, Hmax) with hist_len (B,), drafts (B, k)
    (the JAX package vmaps the one-row function over lanes). Entries past
    hist_len are junk (-1); a draft that runs into them is clipped to id 0
    and rejected by verification. All on hist's device, no host read."""
    single = hist.dim() == 1
    h = hist[None] if single else hist
    dev = h.device
    hmax = h.shape[1]
    # an int is filled on the device: a copy from the host would make the
    # stream wait at every verify
    hl = (hist_len if torch.is_tensor(hist_len)
          else torch.full((), hist_len, device=dev)).reshape(-1).long()
    ar_m = torch.arange(m, device=dev)
    idx = torch.arange(hmax, device=dev)
    # dynamic_slice(hist, (hist_len - m,), (m,)) clamps its start into [0, hmax - m]
    pattern = h.gather(1, (hl - m).clamp(0, hmax - m)[:, None] + ar_m)
    # windows[i, j] = hist[(i + j) mod hmax] (jnp.roll); the wrapped rows fail the mask
    windows = h[:, (idx[:, None] + ar_m[None]) % hmax]
    cand = (windows == pattern[:, None, :]).all(dim=-1) & (idx[None] < (hl - m)[:, None])
    found = cand.any(dim=1) & (hl > m)
    last = torch.where(cand, idx[None], -1).amax(dim=1)
    start = (last + m).clamp(0, hmax - k)
    draft = h.gather(1, start[:, None] + torch.arange(k, device=dev))
    fallback = h.gather(1, (hl - 1).clamp(0, hmax - 1)[:, None]).expand(-1, k)
    draft = torch.where(found[:, None], draft, fallback).clamp(min=0)
    return draft[0] if single else draft


def _write_clamped(buf: torch.Tensor, start: int, vals: torch.Tensor) -> None:
    """buf[start:start + n] = vals with dynamic_update_slice's clamped start."""
    start = max(0, min(start, buf.shape[0] - vals.shape[0]))
    buf[start:start + vals.shape[0]] = vals


def spec_decode_loop(params: Dict, cfg: LlamaConfig, cache: KVCache,
                     first_logits: torch.Tensor, prompt_len: int, dp: DecodeParams,
                     k: int, m: int, hist: torch.Tensor,
                     proposer: Optional[Callable] = None, lora: Optional[Dict] = None,
                     policy: DTypePolicy = FP32) -> Tuple[SpecResult, KVCache]:
    """Speculative greedy decode over a prefilled batch-1 cache whose slots
    [0, prompt_len) hold the prompt; generated token i lands at slot
    prompt_len + i. hist (Hmax,) int32 on the cache's device holds the
    prompt ids, -1 after them, with Hmax >= prompt_len + max_new + k + 1; it
    is written in place. proposer(hist, hist_len) -> (k,) drafts, default
    ``ngram_propose``. Returns (SpecResult, the cache, written in place)."""
    if dp.do_sample:
        raise ValueError("speculative decoding verifies against the greedy argmax; sampled "
                         "decoding needs rejection sampling (not implemented): use generate()")
    if first_logits.shape[0] != 1:
        raise ValueError("speculative decoding is batch-1 (see module docstring)")
    if proposer is None:
        proposer = partial(ngram_propose, k=k, m=m)
    dev = first_logits.device
    s_max = cache.max_len
    max_new, eos, pl = dp.max_new_tokens, dp.eos_token_id, int(prompt_len)
    js = torch.arange(k + 1, device=dev)

    tok0 = torch.argmax(first_logits.float(), dim=-1).to(torch.int32)       # (1,)
    # k + 1 slots of room: one iteration may emit up to k + 1 tokens past the bound
    out = torch.full((max_new + k + 1,), eos, dtype=torch.int32, device=dev)
    out[:1] = tok0
    _write_clamped(hist, pl, tok0)
    c, iters, done = 1, 0, int(tok0[0]) == eos
    while c < max_new and not done:
        hl = pl + c                       # live history length
        draft = proposer(hist, hl)        # (k,)
        block = torch.cat([hist[hl - 1:hl], draft.to(hist.dtype)])[None]    # (1, k+1)
        base = hl - 1                     # slot and position of block[0]
        logits, _ = llama_apply(params, cfg, block, (base + js)[None],
                                causal_mask_bias(k + 1, s_max, offset=base, device=dev),
                                cache=cache, write_pos=base, lora=lora, policy=policy,
                                verify=True)
        g = torch.argmax(logits[0].float(), dim=-1).to(torch.int32)         # (k+1,)
        # g[j]: the model's token after block[:j+1]; draft j survives iff it
        # equals g[j] and every earlier draft survived
        accepted = torch.cumprod((draft == g[:k]).int(), dim=0).sum()
        emit = accepted + 1
        eos_in = (g == eos) & (js < emit)
        has_eos = eos_in.any()
        emit = torch.where(has_eos, torch.argmax(eos_in.int()) + 1, emit)
        # the whole block's outputs; entries past emit are overwritten by the
        # next iteration or trimmed below
        out[c:c + k + 1] = g
        _write_clamped(hist, pl + c, g)
        n, e = torch.stack([emit, has_eos.long()]).tolist()   # the verify's one read
        c, done, iters = c + n, bool(e), iters + 1

    trimmed = out[:max_new]
    eos_hit = trimmed == eos
    gen_len = torch.where(eos_hit.any(), torch.argmax(eos_hit.int()) + 1,
                          torch.full((), max_new, device=dev))
    # overshoot past the first eos -> eos, as the plain loop fills after done
    tokens = torch.where(torch.arange(max_new, device=dev) >= gen_len, eos, trimmed)
    return (SpecResult(tokens[None], gen_len.reshape(1),
                       torch.full((1,), pl, dtype=torch.int32, device=dev), iters), cache)


def generate_spec(params: Dict, cfg: LlamaConfig, tokens: torch.Tensor,
                  dp: DecodeParams = DecodeParams(), k: int = 4, m: int = 3,
                  img_embs: Optional[torch.Tensor] = None, lora: Optional[Dict] = None,
                  policy: DTypePolicy = FP32, cache_len: Optional[int] = None,
                  kv_int8: bool = True, proposer: Optional[Callable] = None) -> SpecResult:
    """``prefill`` and the speculative decode of one sequence: tokens (1, T)
    exact length (no padding: slot == position). The tokens are
    ``generate``'s; only ``iters`` shrinks with acceptance. ``kv_int8``
    defaults to the int8 cache, as the port's ``generate`` (JAX: bf16)."""
    b, t = tokens.shape
    if b != 1:
        raise ValueError("generate_spec is batch-1; batched serving uses generate() or "
                         "the batchers (see module docstring)")
    if cache_len is None:
        cache_len = bucket_length(t + dp.max_new_tokens + k + 1)
    if t + dp.max_new_tokens + k + 1 > cache_len:
        raise ValueError(f"cache too small: {t}+{dp.max_new_tokens}+{k + 1} > {cache_len}")
    dev = tokens.device
    cache, first = prefill(params, cfg, tokens, torch.full((1,), t, dtype=torch.int32,
                                                            device=dev),
                           cache_len, img_embs=img_embs, lora=lora, policy=policy,
                           kv_int8=kv_int8)
    hist = torch.full((cache_len,), -1, dtype=torch.int32, device=dev)
    hist[:t] = tokens[0].to(torch.int32)
    res, _ = spec_decode_loop(params, cfg, cache, first, t, dp, k, m, hist,
                              proposer=proposer, lora=lora, policy=policy)
    return res
