"""BLIP-2 Q-Former (port of radialog_tpu/models/qformer.py): BERT-base with
32 learned query tokens, image cross-attention every
``cross_attention_freq`` layers on the query part, a query FFN beside the
text FFN, and the BERT LM head tied to the word embeddings.

Four entry points, as in the JAX package:
  ``qformer_image_grounded``  queries x image (the LLM's query embeddings,
                              the ITC image leg; ``use_cache`` also returns
                              each layer's query K/V for the LM pass)
  ``qformer_text``            text-only BERT (the ITC text leg)
  ``qformer_multimodal``      [queries; text] x image, bidirectional (ITM)
  ``qformer_lm``              causal text over the cached query prefix (LM)

No dropout runs here: the JAX package's stage-1 path applies none.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..ops.attention import NEG_INF, mha, padding_mask_bias
from ..ops.layers import (DTypePolicy, FP32, embedding_lookup, gelu_exact, layernorm,
                          layernorm_init, linear, linear_init, normal, upcast)
from .bert import (BertConfig, bert_ffn, bert_ffn_init, bert_self_attention,
                   bert_self_attention_init)


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    bert: BertConfig = BertConfig(vocab_size=30523)
    num_query_tokens: int = 32
    encoder_width: int = 1408
    cross_attention_freq: int = 2
    bos_token_id: int = 30522
    pad_token_id: int = 0
    sep_token_id: int = 102


TINY_QFORMER = QFormerConfig(
    bert=BertConfig(vocab_size=128, hidden_size=32, num_layers=4, num_heads=4,
                    intermediate_size=64, max_position=64),
    num_query_tokens=8, encoder_width=48, bos_token_id=120)

KV = Tuple[torch.Tensor, torch.Tensor]
TEXT_SEED_OFFSET = 0x7E47   # the text branch's generator: gen's seed plus this


def qformer_init(gen, cfg: QFormerConfig, device) -> Dict:
    """The whole tree of the JAX package's ``qformer_init``. The leaves the
    image-grounded pass reads come from ``gen``, as many draws as before the
    text branch was built, so whatever a caller draws from ``gen`` next is
    unchanged; the text branch (word and position embeddings, the text
    FFNs, the LM head) comes from a generator of its own, seeded from
    ``gen``'s seed."""
    b = cfg.bert
    text = torch.Generator(device=gen.device).manual_seed(
        (gen.initial_seed() + TEXT_SEED_OFFSET) % 2 ** 63)
    layers = []
    for i in range(b.num_layers):
        layer = {"attn": bert_self_attention_init(gen, b, device),
                 "ffn": bert_ffn_init(text, b, device),
                 "ffn_query": bert_ffn_init(gen, b, device)}
        if i % cfg.cross_attention_freq == 0:
            layer["cross"] = bert_self_attention_init(gen, b, device,
                                                      kv_width=cfg.encoder_width)
        layers.append(layer)
    return {
        "embeddings": {"word": normal(text, (b.vocab_size, b.hidden_size), 0.02, device),
                       "position": normal(text, (b.max_position, b.hidden_size), 0.02, device),
                       "ln": layernorm_init(b.hidden_size, device)},
        "layers": layers,
        "query_tokens": normal(gen, (cfg.num_query_tokens, b.hidden_size), 0.02, device),
        "cls": {"transform": linear_init(text, b.hidden_size, b.hidden_size, device),
                "transform_ln": layernorm_init(b.hidden_size, device),
                "decoder_bias": torch.zeros(b.vocab_size, device=device)},
    }


# ------------------------------------------------------------------- layers
def _split_attention(p: Dict, cfg: BertConfig, x: torch.Tensor, policy: DTypePolicy,
                     bias: Optional[torch.Tensor], kv_prefix: Optional[KV] = None,
                     return_kv: bool = False):
    """BERT self-attention whose keys and values may be extended in front
    by a cached prefix; ``return_kv`` also returns the (extended) K/V."""
    bsz, t, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = linear(p["q"], x, policy).reshape(bsz, t, h, hd)
    k = linear(p["k"], x, policy).reshape(bsz, t, h, hd)
    v = linear(p["v"], x, policy).reshape(bsz, t, h, hd)
    if kv_prefix is not None:
        k = torch.cat([kv_prefix[0], k], dim=1)
        v = torch.cat([kv_prefix[1], v], dim=1)
    o = mha(q, k, v, bias=bias).reshape(bsz, t, cfg.hidden_size)
    o = linear(p["out"], o, policy)
    o = layernorm(p["out_ln"], o + x, cfg.layer_norm_eps)
    return (o, (k, v)) if return_kv else o


def _layer(lp: Dict, cfg: BertConfig, x: torch.Tensor, n_query: int,
           bias: Optional[torch.Tensor], image: Optional[torch.Tensor],
           image_bias: Optional[torch.Tensor], kv_prefix: Optional[KV] = None,
           return_kv: bool = False, policy: DTypePolicy = FP32):
    """One Q-Former layer. The first ``n_query`` positions are queries: they
    get the cross-attention (where the layer has one and an image is given)
    and the query FFN; the rest take the text FFN."""
    res = _split_attention(lp["attn"], cfg, x, policy, bias, kv_prefix, return_kv)
    x, kv = res if return_kv else (res, None)
    if n_query > 0:
        xq, xt = x[:, :n_query], x[:, n_query:]
        if "cross" in lp and image is not None:
            xq = bert_self_attention(lp["cross"], cfg, xq, kv=image, bias=image_bias,
                                     policy=policy)
        xq = bert_ffn(lp["ffn_query"], cfg, xq, policy)
        x = torch.cat([xq, bert_ffn(lp["ffn"], cfg, xt, policy)], dim=1) \
            if xt.shape[1] > 0 else xq
    else:
        x = bert_ffn(lp["ffn"], cfg, x, policy)
    return (x, kv) if return_kv else x


def _embed_text(p: Dict, cfg: BertConfig, input_ids: torch.Tensor,
                position_offset: int = 0) -> torch.Tensor:
    t = input_ids.shape[-1]
    x = embedding_lookup(p["word"], input_ids)
    return x + p["position"][position_offset:position_offset + t][None]


def _embed(p: Dict, cfg: BertConfig, query: Optional[torch.Tensor],
           input_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """Queries ++ text embeddings, then the shared LayerNorm over both."""
    parts = [] if query is None else [query]
    if input_ids is not None:
        dtype = parts[0].dtype if parts else p["word"].dtype
        parts.append(_embed_text(p, cfg, input_ids).to(dtype))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return layernorm(p["ln"], x, cfg.layer_norm_eps)


def _queries(params: Dict, cfg: QFormerConfig, b: int) -> torch.Tensor:
    return params["query_tokens"][None].expand(b, cfg.num_query_tokens, cfg.bert.hidden_size)


# ------------------------------------------------------------- entry points
def qformer_image_grounded(params: Dict, cfg: QFormerConfig, image_embeds: torch.Tensor,
                           image_mask: Optional[torch.Tensor] = None,
                           use_cache: bool = False, policy: DTypePolicy = FP32):
    """Query tokens attend the image. image_embeds (B, N, encoder_width) ->
    hidden (B, nq, H); with ``use_cache`` the pair (hidden, cache), where
    cache holds each layer's query (K, V), each (B, nq, heads, head_dim)."""
    bert = cfg.bert
    x = _embed(params["embeddings"], bert, _queries(params, cfg, image_embeds.shape[0]), None)
    image_bias = padding_mask_bias(image_mask) if image_mask is not None else None
    cache: List[KV] = []
    for lp in params["layers"]:
        x, kv = _layer(lp, bert, x, cfg.num_query_tokens, None, image_embeds, image_bias,
                       return_kv=True, policy=policy)
        cache.append(kv)
    return (x, cache) if use_cache else x


def qformer_text(params: Dict, cfg: QFormerConfig, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor, policy: DTypePolicy = FP32) -> torch.Tensor:
    """Text-only BERT encoding (B, T) -> (B, T, H)."""
    bert = cfg.bert
    x = _embed(params["embeddings"], bert, None, input_ids)
    bias = padding_mask_bias(attention_mask)
    for lp in params["layers"]:
        x = _layer(lp, bert, x, 0, bias, None, None, policy=policy)
    return x


def qformer_multimodal(params: Dict, cfg: QFormerConfig, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor, image_embeds: torch.Tensor,
                       image_mask: Optional[torch.Tensor] = None,
                       policy: DTypePolicy = FP32) -> torch.Tensor:
    """[queries; text] with bidirectional self-attention and the image
    cross-attention on the query part. attention_mask (B, nq + T): ones
    over the queries ++ the text mask. Returns (B, nq + T, H)."""
    bert = cfg.bert
    x = _embed(params["embeddings"], bert, _queries(params, cfg, input_ids.shape[0]), input_ids)
    bias = padding_mask_bias(attention_mask)
    image_bias = padding_mask_bias(image_mask) if image_mask is not None else None
    for lp in params["layers"]:
        x = _layer(lp, bert, x, cfg.num_query_tokens, bias, image_embeds, image_bias,
                   policy=policy)
    return x


def qformer_lm(params: Dict, cfg: QFormerConfig, input_ids: torch.Tensor,
               attention_mask: torch.Tensor, query_cache: List[KV],
               policy: DTypePolicy = FP32) -> torch.Tensor:
    """Causal text decoding over the cached query prefix (UniLM: every text
    position sees all queries and the text up to itself). attention_mask
    (B, nq + T). Returns logits (B, T, vocab) in f32."""
    bert = cfg.bert
    nq, t = cfg.num_query_tokens, input_ids.shape[1]
    x = _embed(params["embeddings"], bert, None, input_ids)
    dev = input_ids.device
    qi = torch.arange(t, device=dev)[:, None]
    kj = torch.arange(t, device=dev)[None, :]
    causal = torch.where(kj <= qi, 0.0, NEG_INF)
    pos_bias = torch.cat([torch.zeros((t, nq), device=dev), causal], dim=-1)[None, None]
    bias = pos_bias + padding_mask_bias(attention_mask)
    for lp, kv in zip(params["layers"], query_cache):
        x = _layer(lp, bert, x, 0, bias, None, None, kv_prefix=kv, policy=policy)
    return qformer_lm_head(params, x, policy)


def qformer_lm_head(params: Dict, hidden: torch.Tensor,
                    policy: DTypePolicy = FP32) -> torch.Tensor:
    """BertLMPredictionHead: dense, GELU, LayerNorm, then the product with
    the word embeddings plus a bias. The product takes operands rounded to
    the compute dtype and sums in f32, as the JAX package's
    ``preferred_element_type=float32`` does (products of bf16 values are
    exact in f32)."""
    c = params["cls"]
    h = layernorm(c["transform_ln"], gelu_exact(linear(c["transform"], hidden, policy)))
    word = params["embeddings"]["word"]
    logits = torch.matmul(upcast(policy.cast(h)), upcast(policy.cast(word)).T)
    return logits + c["decoder_bias"]


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.1,
            ignore_index: int = -100) -> torch.Tensor:
    """Shifted cross entropy with label smoothing, the mean over the labels
    that are not ``ignore_index`` (at least 1)."""
    logits = upcast(logits[:, :-1])
    labels = labels[:, 1:]
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    smooth = -logp.mean(dim=-1)
    per_tok = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    per_tok = torch.where(valid, per_tok, torch.zeros_like(per_tok))
    return per_tok.sum() / torch.clamp(valid.sum(), min=1)
