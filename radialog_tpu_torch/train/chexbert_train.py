"""CheXbert labeler training (port of radialog_tpu/train/chexbert_train.py):
the 14 heads' cross entropies summed over the batch and divided by its
size, a step with dropout in the encoder and on the CLS row, and mean
Cohen's kappa over the 14 conditions as the dev-set selection metric.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.bert import BertConfig
from ..models.chexbert import chexbert_apply
from ..ops.layers import DTypePolicy, FP32
from .optim import GradientTransformation
from .steps import TrainState, _apply, _grads, _on, _trainable


def chexbert_loss(head_logits: List[torch.Tensor], labels: torch.Tensor) -> torch.Tensor:
    """Sum over the heads of the batch-summed cross entropy, divided by the
    batch size. labels (B, 14) int."""
    b = labels.shape[0]
    total = 0.0
    for i, logits in enumerate(head_logits):
        logp = F.log_softmax(logits.float(), dim=-1)
        total = total - logp.gather(-1, labels[:, i:i + 1].long()).sum()
    return total / b


def make_chexbert_train_step(tx: GradientTransformation, cfg: BertConfig,
                             policy: DTypePolicy = FP32) -> Callable:
    """step(state, batch, gen) -> (state, {"loss"}). batch: input_ids and
    attention_mask (B, T), labels (B, 14) int in {0: blank, 1: positive,
    2: negative, 3: uncertain} (the last head in {0, 1}). ``gen`` draws
    the dropout masks."""

    def step(state: TrainState, batch: Dict, gen) -> Tuple[TrainState, Dict]:
        params = _trainable(state.params)
        batch = _on(batch, params["heads"][0]["w"].device)
        logits = chexbert_apply(params, cfg, batch["input_ids"], batch["attention_mask"],
                                policy=policy, train=True, gen=gen)
        loss = chexbert_loss(logits, batch["labels"])
        grads = _grads(loss, params)
        with torch.no_grad():
            new_state = _apply(tx, state, grads)
        return new_state, {"loss": loss.detach()}

    return step


def cohens_kappa(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Unweighted Cohen's kappa between two label vectors."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    cats = np.unique(np.concatenate([y_true, y_pred]))
    n = len(y_true)
    if n == 0:
        return 0.0
    po = float((y_true == y_pred).mean())
    pe = 0.0
    for c in cats:
        pe += float((y_true == c).mean()) * float((y_pred == c).mean())
    if pe >= 1.0:
        return 1.0
    return (po - pe) / (1.0 - pe)


def mean_kappa(labels: np.ndarray, head_preds: np.ndarray) -> Tuple[float, List[float]]:
    """Mean Cohen's kappa over the 14 conditions, and each."""
    ks = [cohens_kappa(labels[:, i], head_preds[:, i]) for i in range(labels.shape[1])]
    return float(np.mean(ks)), ks
