"""BERT encoder (port of radialog_tpu/models/bert.py): the config, the
embeddings, the post-norm attention block and FFN, and the stacked encoder
that the CheXbert labeler and the Q-Former use.

In training (``train=True`` with a generator) dropout at
``cfg.hidden_dropout`` follows the embeddings, each attention output and
each FFN output, as in the JAX package; ``attention_dropout`` is declared
there and never applied, and here likewise."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..ops.attention import mha, padding_mask_bias
from ..ops.layers import (DTypePolicy, FP32, dropout, embedding_lookup, gelu_exact,
                          layernorm, layernorm_init, linear, linear_init, normal)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def bert_embeddings_init(gen, cfg: BertConfig, device) -> Dict:
    return {"word": normal(gen, (cfg.vocab_size, cfg.hidden_size), 0.02, device),
            "position": normal(gen, (cfg.max_position, cfg.hidden_size), 0.02, device),
            "token_type": normal(gen, (cfg.type_vocab_size, cfg.hidden_size), 0.02, device),
            "ln": layernorm_init(cfg.hidden_size, device)}


def bert_embeddings(p: Dict, cfg: BertConfig, input_ids: torch.Tensor,
                    train: bool = False,
                    gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Word + position + token-type embeddings (every token of segment 0),
    then LayerNorm and dropout. Positions past max_position read its last
    row, as the JAX package's clamped gather does."""
    t = input_ids.shape[-1]
    pos = torch.arange(t, device=input_ids.device).clamp(max=cfg.max_position - 1)
    x = embedding_lookup(p["word"], input_ids) + p["position"][pos][None]
    x = x + embedding_lookup(p["token_type"], torch.zeros_like(input_ids))
    return dropout(layernorm(p["ln"], x, cfg.layer_norm_eps), cfg.hidden_dropout, train, gen)


def bert_self_attention_init(gen, cfg: BertConfig, device,
                             kv_width: Optional[int] = None) -> Dict:
    kv_width = kv_width or cfg.hidden_size
    return {
        "q": linear_init(gen, cfg.hidden_size, cfg.hidden_size, device),
        "k": linear_init(gen, kv_width, cfg.hidden_size, device),
        "v": linear_init(gen, kv_width, cfg.hidden_size, device),
        "out": linear_init(gen, cfg.hidden_size, cfg.hidden_size, device),
        "out_ln": layernorm_init(cfg.hidden_size, device),
    }


def bert_self_attention(p: Dict, cfg: BertConfig, x: torch.Tensor,
                        kv: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        policy: DTypePolicy = FP32, train: bool = False,
                        gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Post-norm BERT attention block: attn -> dense -> dropout -> LN(res +
    x). ``kv`` is the source of keys and values for cross-attention."""
    b, t, _ = x.shape
    src = kv if kv is not None else x
    s = src.shape[1]
    h, hd = cfg.num_heads, cfg.head_dim
    q = linear(p["q"], x, policy).reshape(b, t, h, hd)
    k = linear(p["k"], src, policy).reshape(b, s, h, hd)
    v = linear(p["v"], src, policy).reshape(b, s, h, hd)
    o = mha(q, k, v, bias=bias).reshape(b, t, cfg.hidden_size)
    o = dropout(linear(p["out"], o, policy), cfg.hidden_dropout, train, gen)
    return layernorm(p["out_ln"], o + x, cfg.layer_norm_eps)


def bert_ffn_init(gen, cfg: BertConfig, device) -> Dict:
    return {
        "inter": linear_init(gen, cfg.hidden_size, cfg.intermediate_size, device),
        "out": linear_init(gen, cfg.intermediate_size, cfg.hidden_size, device),
        "out_ln": layernorm_init(cfg.hidden_size, device),
    }


def bert_ffn(p: Dict, cfg: BertConfig, x: torch.Tensor, policy: DTypePolicy = FP32,
             train: bool = False, gen: Optional[torch.Generator] = None) -> torch.Tensor:
    h = gelu_exact(linear(p["inter"], x, policy))
    h = dropout(linear(p["out"], h, policy), cfg.hidden_dropout, train, gen)
    return layernorm(p["out_ln"], h + x, cfg.layer_norm_eps)


def bert_encoder_init(gen, cfg: BertConfig, device) -> Dict:
    return {"layers": [{"attn": bert_self_attention_init(gen, cfg, device),
                        "ffn": bert_ffn_init(gen, cfg, device)}
                       for _ in range(cfg.num_layers)]}


def bert_init(gen, cfg: BertConfig, device) -> Dict:
    """Embeddings and encoder (no pooler: CheXbert reads the CLS row)."""
    return {"embeddings": bert_embeddings_init(gen, cfg, device),
            "encoder": bert_encoder_init(gen, cfg, device)}


def bert_apply(p: Dict, cfg: BertConfig, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor] = None,
               policy: DTypePolicy = FP32, train: bool = False,
               gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Last hidden state (B, T, H); padded keys (attention_mask 0) are
    masked in every layer. Dropout draws from ``gen`` in the order the
    layers run."""
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    bias = padding_mask_bias(attention_mask)
    x = bert_embeddings(p["embeddings"], cfg, input_ids, train, gen)
    for lp in p["encoder"]["layers"]:
        x = bert_self_attention(lp["attn"], cfg, x, bias=bias, policy=policy, train=train,
                                gen=gen)
        x = bert_ffn(lp["ffn"], cfg, x, policy=policy, train=train, gen=gen)
    return x
