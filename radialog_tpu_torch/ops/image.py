"""Chest X-ray preprocessing (port of radialog_tpu/ops/image.py) and the
file loader's PIL route (radialog_tpu/native/loader.py ``preprocess_file``).

``preprocess_cxr`` resizes the short side (bilinear, antialiased), takes the
torchvision center crop, scales to [0,1] and replicates the gray channel.
``expand_cxr_u8`` is the device half of the uint8 loader contract: cropped
uint8 grays to 3-channel float in [0,1]. Both divide by 255 through a 0-dim
divisor kept on each device (``div255``): PyTorch's CUDA division by a
Python scalar is a product with its reciprocal, which for 126 of the 256
uint8 values lands one ulp from the IEEE quotient that numpy and JAX give.
``load_image_grayscale`` and ``preprocess_file`` decode on the host with
PIL, imported when called.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _f32_255(device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):   # usable in autograd whoever made it first
        return torch.full((), 255.0, dtype=torch.float32, device=device)


def div255(x: torch.Tensor) -> torch.Tensor:
    """``x / 255`` of an f32 tensor as an IEEE division (numpy's and JAX's),
    with no copy of the divisor from the host."""
    return x / _f32_255(x.device)


def remap_to_uint8_np(array: np.ndarray) -> np.ndarray:
    """Host min/max remap of raw pixel values to uint8 [0, 255]."""
    a = array.astype(np.float64)
    a -= a.min()
    m = a.max()
    if m > 0:
        a /= m
    a *= 255
    return a.astype(np.uint8)


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding an image file needs Pillow (PIL), which is not "
                          "installed") from e
    return Image


def load_image_grayscale(path) -> np.ndarray:
    """JPEG/PNG file -> remapped uint8 grayscale (H, W), decoded by PIL
    (16-bit and 32-bit integer images keep their range before the remap)."""
    with _pil_image().open(path) as im:
        arr = np.asarray(im.convert("L") if im.mode not in ("I;16", "I") else im)
    return remap_to_uint8_np(arr)


def preprocess_file(path, resize: int = 512, crop: int = 448) -> np.ndarray:
    """One image file -> (crop, crop, 3) float32 in [0,1]: PIL decode, remap,
    then ``preprocess_cxr_np`` (the loader's PIL route; native/loader.py
    ``preprocess_file`` takes the C++ decoder where it builds)."""
    return preprocess_cxr_np(load_image_grayscale(path), resize, crop)


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
    x = torch.clamp(div255(x), 0.0, 1.0)
    return x[..., None].repeat(1, 1, 3)


def preprocess_cxr_batch(imgs_u8: torch.Tensor, resize: int = 512,
                         crop: int = 448) -> torch.Tensor:
    """(B, H, W) uint8 of one shape -> (B, crop, crop, 3) float32 in [0,1]:
    ``preprocess_cxr`` of each image, in one batched resize."""
    _, h, w = imgs_u8.shape
    nh, nw = resize_short_side(h, w, resize)
    x = F.interpolate(imgs_u8.float()[:, None], size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=True)[:, 0]
    top = max((nh - crop) // 2, 0)
    left = max((nw - crop) // 2, 0)
    x = x[:, top:top + crop, left:left + crop]
    if nh < crop or nw < crop:
        x = F.pad(x, (0, crop - x.shape[2], 0, crop - x.shape[1]))
    x = torch.clamp(div255(x), 0.0, 1.0)
    return x[..., None].repeat(1, 1, 1, 3)


def expand_cxr_u8(imgs_u8: torch.Tensor) -> torch.Tensor:
    """(B, crop, crop) uint8 -> (B, crop, crop, 3) float32 in [0,1]."""
    x = div255(imgs_u8.float())
    return x[..., None].repeat(1, 1, 1, 3)


def preprocess_cxr_np(img_u8: np.ndarray, resize: int = 512, crop: int = 448) -> np.ndarray:
    """Pure numpy/PIL path: PIL bilinear resize, center crop, [0,1], 3 channels."""
    Image = _pil_image()
    im = Image.fromarray(img_u8).convert("L")
    nh, nw = resize_short_side(im.height, im.width, resize)
    im = im.resize((nw, nh), Image.BILINEAR)
    left = max((nw - crop) // 2, 0)
    top = max((nh - crop) // 2, 0)
    im = im.crop((left, top, left + crop, top + crop))
    x = np.asarray(im, dtype=np.float32) / 255.0
    return np.repeat(x[..., None], 3, axis=-1)
