"""Chest X-ray preprocessing (port of radialog_tpu/ops/image.py).

``preprocess_cxr`` resizes the short side (bilinear, antialiased), takes the
torchvision center crop, scales to [0,1] and replicates the gray channel.
``expand_cxr_u8`` is the device half of the uint8 loader contract: cropped
uint8 grays to 3-channel float in [0,1].
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_short_side(h: int, w: int, target: int) -> Tuple[int, int]:
    """Output (H, W) with the short side == target, aspect preserved."""
    if h <= w:
        return target, max(1, round(w * target / h))
    return max(1, round(h * target / w)), target


def preprocess_cxr(img_u8: torch.Tensor, resize: int = 512, crop: int = 448) -> torch.Tensor:
    """(H, W) uint8 -> (crop, crop, 3) float32 in [0,1], on img_u8's device."""
    h, w = img_u8.shape
    nh, nw = resize_short_side(h, w, resize)
    x = img_u8.float()[None, None]
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                      antialias=True)[0, 0]
    top = max((nh - crop) // 2, 0)
    left = max((nw - crop) // 2, 0)
    x = x[top:top + crop, left:left + crop]
    if nh < crop or nw < crop:
        x = F.pad(x, (0, crop - x.shape[1], 0, crop - x.shape[0]))
    x = torch.clamp(x / 255.0, 0.0, 1.0)
    return x[..., None].repeat(1, 1, 3)


def expand_cxr_u8(imgs_u8: torch.Tensor) -> torch.Tensor:
    """(B, crop, crop) uint8 -> (B, crop, crop, 3) float32 in [0,1]."""
    x = imgs_u8.float() / 255.0
    return x[..., None].repeat(1, 1, 1, 3)


def preprocess_cxr_np(img_u8: np.ndarray, resize: int = 512, crop: int = 448) -> np.ndarray:
    """Pure numpy/PIL path: PIL bilinear resize, center crop, [0,1], 3 channels."""
    from PIL import Image

    im = Image.fromarray(img_u8).convert("L")
    nh, nw = resize_short_side(im.height, im.width, resize)
    im = im.resize((nw, nh), Image.BILINEAR)
    left = max((nw - crop) // 2, 0)
    top = max((nh - crop) // 2, 0)
    im = im.crop((left, top, left + crop, top + crop))
    x = np.asarray(im, dtype=np.float32) / 255.0
    return np.repeat(x[..., None], 3, axis=-1)
