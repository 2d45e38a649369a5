"""CheXbert report labeler: BERT-base + 14 classification heads on the CLS
token (port of radialog_tpu/models/chexbert.py). In training the encoder
drops out as models/bert.py says and the CLS row at 0.1.

Heads: 13 x 4-class (blank / positive / negative / uncertain) + 1 x 2-class
("No Finding"), in CHEXBERT_CONDITIONS order. Labels: argmax 0 -> blank
(NaN), 1 -> 1, 2 -> 0, 3 -> -1 (uncertain); the binary head 0 -> blank,
1 -> 1.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..eval.ce_metrics import CHEXBERT_CONDITIONS, map_labels_for_scoring
from ..ops.layers import DTypePolicy, FP32, dropout, linear, linear_init
from .bert import BertConfig, bert_apply, bert_init


def chexbert_init(gen: torch.Generator, cfg: BertConfig = BertConfig(), device="cuda") -> Dict:
    heads = [linear_init(gen, cfg.hidden_size, 2 if i == 13 else 4, device) for i in range(14)]
    return {"bert": bert_init(gen, cfg, device), "heads": heads}


def chexbert_apply(p: Dict, cfg: BertConfig, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor, policy: DTypePolicy = FP32,
                   train: bool = False,
                   gen: Optional[torch.Generator] = None) -> List[torch.Tensor]:
    """14 logits tensors: 13 x (B,4) + 1 x (B,2), f32."""
    hidden = bert_apply(p["bert"], cfg, input_ids, attention_mask, policy=policy,
                        train=train, gen=gen)
    cls = dropout(hidden[:, 0, :], 0.1, train, gen)
    return [linear(hp, cls, policy).float() for hp in p["heads"]]


def logits_to_labels(head_logits: List) -> np.ndarray:
    """Head argmaxes -> (B, 14) float in {nan, 1, 0, -1}, columns in
    CHEXBERT_CONDITIONS order."""
    batch = head_logits[0].shape[0]
    out = np.full((batch, len(CHEXBERT_CONDITIONS)), np.nan, dtype=np.float64)
    for i, logits in enumerate(head_logits):
        am = np.asarray(logits).argmax(axis=-1)
        if i == 13:      # binary "No Finding": 0 -> blank, 1 -> positive
            out[:, i] = np.where(am == 1, 1.0, np.nan)
        else:
            col = np.full((batch,), np.nan)
            col = np.where(am == 1, 1.0, col)
            col = np.where(am == 2, 0.0, col)
            col = np.where(am == 3, -1.0, col)
            out[:, i] = col
    return out


# NaN -> 0 and -1 (uncertain) -> 0 before scoring: the JAX package's name
# for the metrics module's map
ce_label_cleanup = map_labels_for_scoring
