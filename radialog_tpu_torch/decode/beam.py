"""Beam search (port of radialog_tpu/decode/beam.py: the reference's
``--num_beams`` path).

The prompt's K/V is the same for the K beams of a batch element, and a
reorder permutes only their generated continuations. So the cache is split
in two: the prompt K/V (L, B, S_prompt, H, D), written once by the prefill
at batch B and never copied, and the generated K/V (L, B*K, max_new, H, D),
one slot per generated token, gathered along the beams on every reorder
(``index_select``). One step's attention merges both under one shared
maximum (``_split_attention``), which is one softmax over the concatenated
keys. Finished beams (EOS) extend only with EOS at no cost, and the best
beam is picked by its length-penalized score, as in HF.

Both weight layouts run: the unrolled serving list (W8A8 or W4A8
projections, K1 and K4 on the card) and the stacked float tree, both over
the bf16 cache; the int8 cache and sampling raise. The attention is plain
PyTorch, as it is XLA in the JAX package: no Pallas kernel is behind it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.llama import KVCache, LlamaConfig, _gqa, _layer_view, _mlp, _proj, qkv_proj
from ..ops.layers import DTypePolicy, FP32, embedding_lookup, linear, rmsnorm
from ..ops.rotary import apply_rope, rope_tables
from .engine import DecodeParams, GenerationResult, prefill

NEG_INF = -1e30


def _split_attention(q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                     gk: torch.Tensor, gv: torch.Tensor, prompt_bias: torch.Tensor,
                     gen_bias: torch.Tensor, nh: int, beams: int) -> torch.Tensor:
    """One token's attention over the split cache: q (B*K, 1, nh, hd);
    pk/pv (B, S_p, nkv, hd) shared by a batch element's beams; gk/gv (B*K,
    S_g, nkv, hd) per beam; prompt_bias (B, 1, 1, S_p); gen_bias (S_g,).
    Scores and sums in f32, p rounded to V's dtype before p @ V, as the JAX
    version's preferred_element_type=f32 products. Returns (B*K, 1, nh*hd)."""
    bk, _, _, hd = q.shape
    b = bk // beams
    pk, pv, gk, gv = (_gqa(x, nh, 2) for x in (pk, pv, gk, gv))
    scale = hd ** -0.5
    qf = q.float()
    s_p = torch.einsum("bkhd,bshd->bkhs", qf.reshape(b, beams, nh, hd), pk.float()) * scale
    s_p = (s_p + prompt_bias.float()).reshape(bk, nh, -1)
    s_g = torch.einsum("bhd,bshd->bhs", qf[:, 0], gk.float()) * scale + gen_bias.float()
    m = torch.maximum(s_p.amax(-1), s_g.amax(-1))          # (B*K, nh)
    ep = torch.exp(s_p - m[..., None])
    eg = torch.exp(s_g - m[..., None])
    denom = ep.sum(-1) + eg.sum(-1)
    o_p = torch.einsum("bkhs,bshd->bkhd", ep.reshape(b, beams, nh, -1).to(pv.dtype).float(),
                       pv.float()).reshape(bk, nh, hd)
    o_g = torch.einsum("bhs,bshd->bhd", eg.to(gv.dtype).float(), gv.float())
    o = (o_p + o_g) / denom[..., None]
    return o.reshape(bk, 1, nh * hd).to(q.dtype)


def _beam_forward(params: Dict, cfg: LlamaConfig, last_tok: torch.Tensor,
                  positions: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                  prompt_bias: torch.Tensor, gk: torch.Tensor, gv: torch.Tensor, step: int,
                  beams: int, lora: Optional[Dict], policy: DTypePolicy) -> torch.Tensor:
    """One decode step at B*K rows against the split cache: writes each
    layer's new K/V into generated slot ``step`` of gk/gv (in place) and
    returns the logits (B*K, V) in f32. Either weight layout."""
    x = embedding_lookup(params["embed"], last_tok[:, None]).to(policy.compute)
    cos, sin = rope_tables(cfg.head_dim, cfg.max_position, cfg.rope_theta, device=x.device)
    lora_scale = lora["scale"] if lora is not None else None
    lora_layers = lora["layers"] if lora is not None else None
    gen_bias = torch.where(torch.arange(gk.shape[2], device=x.device) <= step, 0.0, NEG_INF)
    stacked = not isinstance(params["layers"], (list, tuple))
    for i in range(cfg.num_layers if stacked else len(params["layers"])):
        lp = _layer_view(params["layers"], i) if stacked else params["layers"][i]
        ll = _layer_view(lora_layers, i) if lora_layers is not None else None
        h = rmsnorm(lp["input_ln"], x, cfg.rms_eps)
        q, k, v = qkv_proj(lp, ll, lora_scale, cfg, h, policy)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        gk[i, :, step] = k[:, 0].to(gk.dtype)
        gv[i, :, step] = v[:, 0].to(gv.dtype)
        o = _split_attention(q, pk[i].to(x.dtype), pv[i].to(x.dtype), gk[i].to(x.dtype),
                             gv[i].to(x.dtype), prompt_bias, gen_bias, cfg.num_heads, beams)
        x = x + _proj(lp, ll, "wo", o, lora_scale, policy)
        x = x + _mlp(lp, rmsnorm(lp["post_ln"], x, cfg.rms_eps), policy)
    x = rmsnorm(params["final_ln"], x, cfg.rms_eps)
    return linear(params["lm_head"], x, policy).float()[:, 0]


@torch.no_grad()
def beam_decode(params: Dict, cfg: LlamaConfig, cache: KVCache, first_logits: torch.Tensor,
                prompt_lengths: torch.Tensor, prompt_pad: int, dp: DecodeParams,
                num_beams: int, lora: Optional[Dict] = None, policy: DTypePolicy = FP32,
                length_penalty: float = 1.0) -> GenerationResult:
    """Beam-decode from a prefill: ``cache`` the bf16 prompt K/V at batch B
    (only slots [0, prompt_pad) are read), ``first_logits`` (B, V). Returns
    each batch element's best beam."""
    if cache.quantized:
        raise ValueError("beam search uses the bf16 KV cache (quality path); "
                         "prefill with kv_int8=False")
    if dp.do_sample:
        raise NotImplementedError(
            "beam search is deterministic (length-penalized greedy over "
            "beams); do_sample=True with num_beams>1 is not supported — "
            "silent fallback would return identical 'sampled' outputs")
    b, vocab = first_logits.shape
    k, max_new, eos = num_beams, dp.max_new_tokens, dp.eos_token_id
    dev = first_logits.device

    pk = cache.k[:, :, :prompt_pad]
    pv = cache.v[:, :, :prompt_pad]
    # prompt slots j < len_b are live; the right-pad tail is not
    kj = torch.arange(prompt_pad, device=dev)[None, :]
    prompt_bias = torch.where(kj < prompt_lengths[:, None], 0.0, NEG_INF)[:, None, None, :]
    gshape = (cfg.num_layers, b * k, max_new, cfg.num_kv_heads, cfg.head_dim)
    gk = torch.zeros(gshape, dtype=cache.k.dtype, device=dev)
    gv = torch.zeros(gshape, dtype=cache.v.dtype, device=dev)
    lengths_bk = prompt_lengths.repeat_interleave(k)

    top0 = torch.topk(torch.log_softmax(first_logits.float(), dim=-1), k, dim=-1)
    tok = top0.indices.reshape(b * k).to(torch.int32)
    scores = top0.values.reshape(b * k)
    out = torch.full((b * k, max_new), eos, dtype=torch.int32, device=dev)
    out[:, 0] = tok
    done = tok == eos
    eos_only = torch.full((vocab,), NEG_INF, device=dev)
    eos_only[eos] = 0.0
    batch_rows = torch.arange(b, device=dev)[:, None] * k

    # step + 1 < max_new: step s emits out[:, s + 1]; one more step would
    # score and reorder by a token that is never written
    step = 0
    while step + 1 < max_new and not bool(done.all()):
        pos = (lengths_bk + step)[:, None]
        logits = _beam_forward(params, cfg, tok, pos, pk, pv, prompt_bias, gk, gv, step, k,
                               lora, policy)
        logp = torch.log_softmax(logits, dim=-1)
        logp = torch.where(done[:, None], eos_only[None, :], logp)   # finished: EOS, no cost
        top = torch.topk((scores[:, None] + logp).reshape(b, k * vocab), k, dim=-1)
        scores = top.values.reshape(b * k)
        tok = (top.indices % vocab).reshape(b * k).to(torch.int32)
        # beam-major rows of the generated region only: the prompt K/V is shared
        src_rows = (batch_rows + top.indices // vocab).reshape(b * k)
        gk = gk.index_select(1, src_rows)
        gv = gv.index_select(1, src_rows)
        out = out.index_select(0, src_rows)
        out[:, step + 1] = tok
        done = done.index_select(0, src_rows) | (tok == eos)
        step += 1

    eos_hit = out == eos
    gen_len = torch.where(eos_hit.any(dim=1), torch.argmax(eos_hit.int(), dim=1) + 1,
                          torch.full((b * k,), max_new, device=dev))
    norm = scores / gen_len.float() ** length_penalty
    rows = torch.arange(b, device=dev) * k + torch.argmax(norm.reshape(b, k), dim=1)
    return GenerationResult(out[rows], gen_len[rows], prompt_lengths)


@torch.no_grad()
def generate_beam(params: Dict, cfg: LlamaConfig, tokens: torch.Tensor,
                  lengths: torch.Tensor, dp: DecodeParams, num_beams: int,
                  img_embs: Optional[torch.Tensor] = None, lora: Optional[Dict] = None,
                  policy: DTypePolicy = FP32, cache_len: Optional[int] = None
                  ) -> GenerationResult:
    """Prefill once at batch B on the bf16 cache, then beam-decode at
    B*num_beams. ``cache_len`` is taken for generate()'s signature and not
    used: the prompt K/V is sized by the padded prompt, the generated K/V by
    max_new_tokens."""
    del cache_len
    t = tokens.shape[1]
    cache, last = prefill(params, cfg, tokens, lengths, t, img_embs=img_embs, lora=lora,
                          policy=policy, kv_int8=False)
    return beam_decode(params, cfg, cache, last, lengths, t, dp, num_beams, lora=lora,
                       policy=policy)
