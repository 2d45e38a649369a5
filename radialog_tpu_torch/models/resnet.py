"""ResNet-18/50 trunk, NHWC, eval mode (port of radialog_tpu/models/resnet.py).

Returns the penultimate feature map: (B, H/32, W/32, C) — 14x14x2048 for a
448 input to ResNet-50, 16x16 for the classifier's 488 crop.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..ops.layers import (DTypePolicy, FP32, batchnorm, batchnorm_init, conv2d,
                          conv2d_init, max_pool2d)

RESNET50_LAYERS = (3, 4, 6, 3)
RESNET18_LAYERS = (2, 2, 2, 2)


def _bottleneck_init(gen, in_ch: int, width: int, stride: int, device) -> Tuple[dict, dict]:
    out_ch = width * 4
    p: Dict = {}
    s: Dict = {}
    p["conv1"] = conv2d_init(gen, in_ch, width, 1, device)
    p["bn1"], s["bn1"] = batchnorm_init(width, device)
    p["conv2"] = conv2d_init(gen, width, width, 3, device)
    p["bn2"], s["bn2"] = batchnorm_init(width, device)
    p["conv3"] = conv2d_init(gen, width, out_ch, 1, device)
    p["bn3"], s["bn3"] = batchnorm_init(out_ch, device)
    if stride != 1 or in_ch != out_ch:
        p["down_conv"] = conv2d_init(gen, in_ch, out_ch, 1, device)
        p["down_bn"], s["down_bn"] = batchnorm_init(out_ch, device)
    return p, s


def _bottleneck(p, s, x, stride: int, policy: DTypePolicy):
    y = torch.relu(batchnorm(p["bn1"], s["bn1"], conv2d(p["conv1"], x, 1, "SAME", policy=policy)))
    y = torch.relu(batchnorm(p["bn2"], s["bn2"], conv2d(p["conv2"], y, stride, 1, policy=policy)))
    y = batchnorm(p["bn3"], s["bn3"], conv2d(p["conv3"], y, 1, "SAME", policy=policy))
    if "down_conv" in p:
        idn = batchnorm(p["down_bn"], s["down_bn"],
                        conv2d(p["down_conv"], x, stride, "SAME", policy=policy))
    else:
        idn = x
    return torch.relu(y + idn)


def _basic_init(gen, in_ch: int, width: int, stride: int, device) -> Tuple[dict, dict]:
    p: Dict = {}
    s: Dict = {}
    p["conv1"] = conv2d_init(gen, in_ch, width, 3, device)
    p["bn1"], s["bn1"] = batchnorm_init(width, device)
    p["conv2"] = conv2d_init(gen, width, width, 3, device)
    p["bn2"], s["bn2"] = batchnorm_init(width, device)
    if stride != 1 or in_ch != width:
        p["down_conv"] = conv2d_init(gen, in_ch, width, 1, device)
        p["down_bn"], s["down_bn"] = batchnorm_init(width, device)
    return p, s


def _basic(p, s, x, stride: int, policy: DTypePolicy):
    y = torch.relu(batchnorm(p["bn1"], s["bn1"], conv2d(p["conv1"], x, stride, 1, policy=policy)))
    y = batchnorm(p["bn2"], s["bn2"], conv2d(p["conv2"], y, 1, 1, policy=policy))
    if "down_conv" in p:
        idn = batchnorm(p["down_bn"], s["down_bn"],
                        conv2d(p["down_conv"], x, stride, "SAME", policy=policy))
    else:
        idn = x
    return torch.relu(y + idn)


def resnet_init(gen, device, layers: Tuple[int, ...] = RESNET50_LAYERS,
                bottleneck: bool = True) -> Tuple[dict, dict]:
    p: Dict = {"conv1": conv2d_init(gen, 3, 64, 7, device)}
    s: Dict = {}
    p["bn1"], s["bn1"] = batchnorm_init(64, device)
    in_ch = 64
    expansion = 4 if bottleneck else 1
    init_fn = _bottleneck_init if bottleneck else _basic_init
    for stage, n_blocks in enumerate(layers):
        width = 64 * (2 ** stage)
        blocks_p: List = []
        blocks_s: List = []
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            bp, bs = init_fn(gen, in_ch, width, stride, device)
            blocks_p.append(bp)
            blocks_s.append(bs)
            in_ch = width * expansion
        p[f"layer{stage + 1}"] = blocks_p
        s[f"layer{stage + 1}"] = blocks_s
    return p, s


def resnet_apply(p: dict, s: dict, x: torch.Tensor, policy: DTypePolicy = FP32) -> torch.Tensor:
    """x (B,H,W,3) -> x4 feature map (B,H/32,W/32,C). Block type is read
    from the parameter tree."""
    block_fn = _bottleneck if "conv3" in p["layer1"][0] else _basic
    y = torch.relu(batchnorm(p["bn1"], s["bn1"], conv2d(p["conv1"], x, 2, 3, policy=policy)))
    y = max_pool2d(y, 3, 2, 1)
    for stage in range(1, 5):
        for b, (bp, bs) in enumerate(zip(p[f"layer{stage}"], s[f"layer{stage}"])):
            stride = 2 if (b == 0 and stage > 1) else 1
            y = block_fn(bp, bs, y, stride, policy)
    return y
