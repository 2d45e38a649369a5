"""BERT pieces the Q-Former uses (port of part of radialog_tpu/models/bert.py):
the config, the post-norm attention block's parameters and the FFN."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..ops.layers import (DTypePolicy, FP32, gelu_exact, layernorm, layernorm_init,
                          linear, linear_init)


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
    pad_token_id: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


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


def bert_ffn_init(gen, cfg: BertConfig, device) -> Dict:
    return {
        "inter": linear_init(gen, cfg.hidden_size, cfg.intermediate_size, device),
        "out": linear_init(gen, cfg.intermediate_size, cfg.hidden_size, device),
        "out_ln": layernorm_init(cfg.hidden_size, device),
    }


def bert_ffn(p: Dict, cfg: BertConfig, x: torch.Tensor,
             policy: DTypePolicy = FP32) -> torch.Tensor:
    h = gelu_exact(linear(p["inter"], x, policy))
    h = linear(p["out"], h, policy)
    return layernorm(p["out_ln"], h + x, cfg.layer_norm_eps)
