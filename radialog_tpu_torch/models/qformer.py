"""BLIP-2 Q-Former, image-grounded query pass (port of the
``qformer_image_grounded`` entry point of radialog_tpu/models/qformer.py).

32 learned queries, BERT-base self-attention, image cross-attention every
``cross_attention_freq`` layers, and the query FFN. The text, ITM and LM
entry points are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..ops.attention import padding_mask_bias
from ..ops.layers import DTypePolicy, FP32, layernorm, layernorm_init, normal
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


def qformer_init(gen, cfg: QFormerConfig, device) -> Dict:
    """The parameters the image-grounded pass reads (the word/position
    embeddings, text FFNs and LM head of the text branches are not built)."""
    b = cfg.bert
    layers = []
    for i in range(b.num_layers):
        layer = {"attn": bert_self_attention_init(gen, b, device),
                 "ffn_query": bert_ffn_init(gen, b, device)}
        if i % cfg.cross_attention_freq == 0:
            layer["cross"] = bert_self_attention_init(gen, b, device,
                                                      kv_width=cfg.encoder_width)
        layers.append(layer)
    return {"embeddings": {"ln": layernorm_init(b.hidden_size, device)},
            "layers": layers,
            "query_tokens": normal(gen, (cfg.num_query_tokens, b.hidden_size), 0.02, device)}


def qformer_image_grounded(params: Dict, cfg: QFormerConfig, image_embeds: torch.Tensor,
                           image_mask: Optional[torch.Tensor] = None,
                           policy: DTypePolicy = FP32) -> torch.Tensor:
    """Query tokens attend the image. image_embeds (B, N, encoder_width) ->
    hidden (B, nq, H)."""
    b = image_embeds.shape[0]
    bert = cfg.bert
    x = params["query_tokens"][None].expand(b, -1, -1)
    x = layernorm(params["embeddings"]["ln"], x, bert.layer_norm_eps)
    image_bias = padding_mask_bias(image_mask) if image_mask is not None else None
    for lp in params["layers"]:
        x = bert_self_attention(lp["attn"], bert, x, policy=policy)
        if "cross" in lp:
            x = bert_self_attention(lp["cross"], bert, x, kv=image_embeds, bias=image_bias,
                                    policy=policy)
        x = bert_ffn(lp["ffn_query"], bert, x, policy)
    return x
