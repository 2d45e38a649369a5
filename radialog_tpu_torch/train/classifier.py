"""Findings-classifier training (port of radialog_tpu/train/classifier.py):
BCE with per-class positive weights, BatchNorm trained on batch statistics,
macro-F1 model selection and the structured-predictions JSON.

Class weights follow the reference's dataset (none | lin = N/count | log =
log(N/count)); ``save_structured_predictions`` writes the same bytes as the
JAX package for the same decisions.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.chexpert import CHEXPERT_CLASSES, bce_with_logits_loss, chexpert_classifier_apply
from ..ops.augment import augment_cxr_batch
from ..ops.layers import DTypePolicy, FP32
from .optim import GradientTransformation
from .steps import TrainState, _apply, _grads, _on, _trainable


def class_weights(labels: np.ndarray, weighting: str = "log") -> np.ndarray:
    """(N, 14) binary labels -> per-class pos_weight (float32)."""
    labels = np.asarray(labels, np.float64)
    n = len(labels)
    counts = np.maximum(labels.sum(0), 1.0)
    if weighting == "none":
        return np.ones(labels.shape[1], np.float32)
    if weighting == "lin":
        return (n / counts).astype(np.float32)
    if weighting == "log":
        return np.log(n / counts).astype(np.float32)
    raise ValueError(f"unknown weighting '{weighting}'")


def make_classifier_train_step(tx: GradientTransformation,
                               pos_weight: Optional[np.ndarray] = None,
                               policy: DTypePolicy = FP32,
                               augment: bool = False) -> Callable:
    """step(state, model_state, batch[, gen]) -> (state, model_state,
    {"loss", "logits"}). batch: images (B, 488, 488, 3) in [0, 1], labels
    (B, 14). Every BatchNorm normalizes with the batch's statistics and its
    running stats come back as the new model_state. With ``augment`` the
    reference's train augmentation (RandomAffine 30 deg / shear 15 and
    ColorJitter 0.2 / 0.2, ops/augment.py) runs on the device first, its
    draws from ``gen``."""
    pw_on: Dict = {}     # pos_weight copied to each device once, not at every step

    def step(state: TrainState, model_state: Dict, batch: Dict, gen=None):
        params = _trainable(state.params)
        device = params["fc2"]["w"].device
        batch = _on(batch, device)
        images = batch["images"]
        if augment:
            with torch.no_grad():
                images = augment_cxr_batch(images, gen)
        if pos_weight is not None and device not in pw_on:
            pw_on[device] = torch.as_tensor(pos_weight, device=device)
        logits, new_model_state = chexpert_classifier_apply(params, model_state, images,
                                                            policy, train=True)
        loss = bce_with_logits_loss(logits, batch["labels"], pw_on.get(device))
        grads = _grads(loss, params)
        with torch.no_grad():
            new_state = _apply(tx, state, grads)
        return new_state, new_model_state, {"loss": loss.detach(), "logits": logits.detach()}

    return step


def multilabel_f1(labels: np.ndarray, probs: np.ndarray,
                  threshold: float = 0.5) -> Dict[str, float]:
    """Macro F1 and accuracy over sigmoid > threshold decisions."""
    y = np.asarray(labels) > 0.5
    p = np.asarray(probs) > threshold
    tp = (y & p).sum(0).astype(np.float64)
    fp = (~y & p).sum(0).astype(np.float64)
    fn = (y & ~p).sum(0).astype(np.float64)
    prec = np.divide(tp, tp + fp, out=np.zeros_like(tp), where=(tp + fp) > 0)
    rec = np.divide(tp, tp + fn, out=np.zeros_like(tp), where=(tp + fn) > 0)
    f1 = np.divide(2 * prec * rec, prec + rec, out=np.zeros_like(tp),
                   where=(prec + rec) > 0)
    return {"val_f1": float(f1.mean()),
            "val_acc": float((y == p).mean()),
            "per_class_f1": f1.tolist()}


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_structured_predictions(predict_fn: Callable, batches, out_path) -> Dict[str, list]:
    """Write structured_preds_*.json: dicom -> its positive finding names.
    ``batches`` yields (dicom_ids, images); ``predict_fn(images)`` gives
    the probabilities (a tensor or an array)."""
    names = np.asarray(CHEXPERT_CLASSES)
    out: Dict[str, list] = {}
    for dicom_ids, images in batches:
        probs = _numpy(predict_fn(images))
        for d, row in zip(dicom_ids, probs > 0.5):
            out[str(d)] = names[row].tolist()
    Path(out_path).write_text(json.dumps(out, indent=4))
    return out
