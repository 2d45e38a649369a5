"""BLIP-2 query embeddings for the LLM (port of ``Blip2Config`` and
``blip2_forward_image`` of radialog_tpu/models/blip2.py; the stage-1 losses
are not ported yet)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..ops.layers import DTypePolicy, FP32
from .qformer import QFormerConfig, qformer_image_grounded


@dataclasses.dataclass(frozen=True)
class Blip2Config:
    qformer: QFormerConfig = QFormerConfig()
    embed_dim: int = 256
    max_txt_len: int = 256
    image_size: int = 448


def blip2_forward_image(params: Dict, cfg: Blip2Config, image_embeds: torch.Tensor,
                        policy: DTypePolicy = FP32) -> torch.Tensor:
    """ln_vision'd patch tokens (B, N, encoder_width) -> (B, 32, 768)."""
    return qformer_image_grounded(params["qformer"], cfg.qformer, image_embeds,
                                  policy=policy)
