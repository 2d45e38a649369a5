"""BioViL-T image model, eval mode (port of radialog_tpu/models/biovil_t.py).

  image (B,448,448,3) --resnet50--> (B,14,14,2048) --1x1--> patch_x (256)
  no prior: diff = broadcast missing_previous_emb; else vit_pooler
  patch_fused = [patch_x, diff] (512) -> projector 512 -> J -> J
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..ops.layers import (DTypePolicy, FP32, batchnorm, batchnorm_init, conv2d,
                          conv2d_init, global_avg_pool, normal)
from .resnet import RESNET50_LAYERS, resnet_apply, resnet_init
from .vit_pooler import vit_pooler_apply, vit_pooler_init

VIT_DIM = 256
FUSED_DIM = 2 * VIT_DIM


class ImageModelOutput(NamedTuple):
    img_embedding: torch.Tensor               # (B, 512)
    patch_embeddings: torch.Tensor            # (B, h, w, 512)
    projected_patch_embeddings: torch.Tensor  # (B, h, w, J)
    projected_global_embedding: torch.Tensor  # (B, J)


def biovil_t_init(gen, device, joint_feature_size: int = 128,
                  resnet_layers=RESNET50_LAYERS, bottleneck: bool = True) -> Tuple[Dict, Dict]:
    params: Dict = {}
    state: Dict = {}
    params["resnet"], state["resnet"] = resnet_init(gen, device, resnet_layers, bottleneck)
    trunk_out = 512 * (4 if bottleneck else 1)
    params["backbone_to_vit"] = conv2d_init(gen, trunk_out, VIT_DIM, 1, device)
    params["vit_pooler"] = vit_pooler_init(gen, device, dim=VIT_DIM, grid=(14, 14))
    params["missing_previous_emb"] = normal(gen, (VIT_DIM,), 0.02, device)
    params["proj1"] = conv2d_init(gen, FUSED_DIM, joint_feature_size, 1, device)
    params["proj_bn"], state["proj_bn"] = batchnorm_init(joint_feature_size, device)
    params["proj2"] = conv2d_init(gen, joint_feature_size, joint_feature_size, 1, device,
                                  bias=True)
    return params, state


def biovil_t_apply(params: Dict, state: Dict, current: torch.Tensor,
                   previous: Optional[torch.Tensor] = None,
                   policy: DTypePolicy = FP32) -> ImageModelOutput:
    """current/previous (B,H,W,3) float in [0,1]."""
    if previous is not None:
        feats = resnet_apply(params["resnet"], state["resnet"],
                             torch.cat([current, previous], dim=0), policy)
        feats = conv2d(params["backbone_to_vit"], feats, 1, "SAME", policy=policy)
        b = current.shape[0]
        patch_x = feats[:b]
        diff = vit_pooler_apply(params["vit_pooler"], patch_x, feats[b:], policy=policy)
    else:
        feats = resnet_apply(params["resnet"], state["resnet"], current, policy)
        patch_x = conv2d(params["backbone_to_vit"], feats, 1, "SAME", policy=policy)
        diff = params["missing_previous_emb"].to(patch_x.dtype).expand(patch_x.shape)
    patch_fused = torch.cat([patch_x, diff], dim=-1)
    pooled = global_avg_pool(patch_fused)
    proj = conv2d(params["proj1"], patch_fused, 1, "SAME", policy=policy)
    proj = torch.relu(batchnorm(params["proj_bn"], state["proj_bn"], proj))
    proj = conv2d(params["proj2"], proj, 1, "SAME", policy=policy)
    return ImageModelOutput(pooled, patch_fused, proj, proj.mean(dim=(1, 2)))


def patch_tokens_for_qformer(projected_patch: torch.Tensor) -> torch.Tensor:
    """(B, h, w, J) -> (B, h*w, J) with the reference's channel-major
    reshape: the NCHW tensor (B,J,h,w) is reshaped straight to (B,h*w,J),
    scrambling channels across positions, which the released Q-Former
    weights expect."""
    b, h, w, c = projected_patch.shape
    return projected_patch.permute(0, 3, 1, 2).reshape(b, h * w, c)
