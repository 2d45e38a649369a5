"""CheXpert findings classifier: BioViL-T trunk + 2-layer MLP head (port of
radialog_tpu/models/chexpert.py). Input crop 488: stride 32 gives a 16x16
grid, avg_pool(4) -> 4x4, NCHW flatten 2048 -> fc1(512) -> relu -> fc2(14).
14-way multilabel, trained with BCE-with-logits and per-class positive
weights (train/classifier.py)."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.layers import DTypePolicy, FP32, avg_pool2d, linear, linear_init
from .biovil_t import RESNET50_LAYERS, biovil_t_apply, biovil_t_init

CHEXPERT_CLASSES = (
    "No Finding", "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity",
    "Lung Lesion", "Edema", "Consolidation", "Pneumonia", "Atelectasis",
    "Pneumothorax", "Pleural Effusion", "Pleural Other", "Fracture",
    "Support Devices",
)
NUM_CLASSES = len(CHEXPERT_CLASSES)
CLASSIFIER_CROP = 488


def chexpert_classifier_init(gen, device, num_classes: int = NUM_CLASSES,
                             resnet_layers=RESNET50_LAYERS,
                             bottleneck: bool = True) -> Tuple[Dict, Dict]:
    params: Dict = {}
    params["biovil"], state = biovil_t_init(gen, device, 128, resnet_layers, bottleneck)
    params["fc1"] = linear_init(gen, 128 * 4 * 4, 512, device)
    params["fc2"] = linear_init(gen, 512, num_classes, device)
    return params, {"biovil": state}


def chexpert_classifier_apply(params: Dict, state: Dict, images: torch.Tensor,
                              policy: DTypePolicy = FP32, train: bool = False,
                              gen: Optional[torch.Generator] = None):
    """images (B, 488, 488, 3) in [0,1] -> logits (B, 14) f32; with
    ``train`` (BatchNorm on batch statistics), (logits, new state)."""
    out = biovil_t_apply(params["biovil"], state["biovil"], images, policy=policy,
                         train=train, gen=gen)
    if train:
        out, new_biovil = out
    x = avg_pool2d(out.projected_patch_embeddings, 4)
    x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)   # torch NCHW flatten order
    x = torch.relu(linear(params["fc1"], x, policy))
    logits = linear(params["fc2"], x, policy).float()
    return (logits, {"biovil": new_biovil}) if train else logits


def bce_with_logits_loss(logits: torch.Tensor, targets: torch.Tensor,
                         pos_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch's BCEWithLogitsLoss(pos_weight=...), mean over every entry, in
    the JAX package's order of operations."""
    logits, targets = logits.float(), targets.float()
    per = -(targets * F.logsigmoid(logits) * (pos_weight if pos_weight is not None else 1.0)
            + (1.0 - targets) * F.logsigmoid(-logits))
    return per.mean()


def predicted_findings(logits: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """sigmoid > threshold multilabel decisions."""
    return torch.sigmoid(logits) > threshold


def findings_to_text(pred_row) -> List[str]:
    """Boolean row (14,) -> the positive class names."""
    return [CHEXPERT_CLASSES[i] for i, v in enumerate(pred_row) if bool(v)]
