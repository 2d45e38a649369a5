"""Train-time image augmentations (port of radialog_tpu/ops/augment.py), on
the images' device, batched.

torchvision's ``Compose([RandomAffine(degrees=30, shear=15),
ColorJitter(brightness=0.2, contrast=0.2)])`` as the JAX package computes
it:
  RandomAffine: angle ~ U(-30, 30) degrees, x-shear ~ U(-15, 15) degrees,
    no translation or scale, NEAREST sampling through the inverse matrix,
    fill 0, centred on the image centre;
  ColorJitter: factors ~ U(0.8, 1.2); brightness scales the image, contrast
    blends it with the mean of its grayscale; each blend clamps to [0, 1];
    the two run in an order drawn per image.

Every draw of a batch comes from ``augment_draws``, one module-level
function of a generator, so that a test can hand in the JAX package's own
draws. The transforms themselves take the drawn values.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch


def _uniform(gen, n: int, lo: float, hi: float, device) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    return u * (hi - lo) + lo


def affine_params(gen: Optional[torch.Generator], degrees: float = 30.0, shear: float = 15.0,
                  n: int = 1, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(angle_deg, shear_x_deg), each (n,), as RandomAffine.get_params."""
    return (_uniform(gen, n, -degrees, degrees, device),
            _uniform(gen, n, -shear, shear, device))


def augment_draws(n: int, gen: Optional[torch.Generator], degrees: float = 30.0,
                  shear: float = 15.0, brightness: float = 0.2, contrast: float = 0.2,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """Every random value ``augment_cxr_batch`` needs for n images: angle,
    shear, brightness and contrast factors (n,) f32 and brightness_first
    (n,) bool."""
    angle, shear_x = affine_params(gen, degrees, shear, n, device)
    return {"angle": angle, "shear": shear_x,
            "brightness": _uniform(gen, n, 1.0 - brightness, 1.0 + brightness, device),
            "contrast": _uniform(gen, n, 1.0 - contrast, 1.0 + contrast, device),
            "brightness_first": torch.rand(n, generator=gen, device=device) < 0.5}


def _inverse_rss(angle_deg: torch.Tensor, shear_x_deg: torch.Tensor) -> torch.Tensor:
    """(n,) angles and x-shears -> (n, 2, 2): the inverse of the rotate +
    shear matrix (scale 1, no y-shear, determinant 1), [[d, -b], [-c, a]]."""
    r = angle_deg * (math.pi / 180)
    sx = shear_x_deg * (math.pi / 180)
    a = torch.cos(r)
    b = -torch.cos(r) * torch.tan(sx) - torch.sin(r)
    c = torch.sin(r)
    d = -torch.sin(r) * torch.tan(sx) + torch.cos(r)
    return torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)


def random_affine(imgs: torch.Tensor, angle: torch.Tensor, shear_x: torch.Tensor,
                  fill: float = 0.0) -> torch.Tensor:
    """(B, H, W, C) -> rotated and sheared, NEAREST, ``fill`` outside: output
    pixel (y, x) takes the input at M_inv @ ([x, y] - centre) + centre,
    rounded half to even, each product and sum in f32 in the JAX order."""
    bsz, h, w = imgs.shape[:3]
    m = _inverse_rss(angle, shear_x)[:, :, :, None, None]       # (B, 2, 2, 1, 1)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dev = imgs.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w) - cy
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :].expand(h, w) - cx
    xin = m[:, 0, 0] * xs + m[:, 0, 1] * ys + cx
    yin = m[:, 1, 0] * xs + m[:, 1, 1] * ys + cy
    xi = torch.round(xin).to(torch.int64)
    yi = torch.round(yin).to(torch.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    rows = torch.arange(bsz, device=dev)[:, None, None]
    gathered = imgs[rows, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
    return torch.where(valid[..., None], gathered, torch.full_like(gathered[:1, :1, :1], fill))


def _blend(img: torch.Tensor, other: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    return torch.clamp(ratio * img + (1.0 - ratio) * other, 0.0, 1.0)


def color_jitter(imgs: torch.Tensor, brightness: torch.Tensor, contrast: torch.Tensor,
                 brightness_first: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) in [0, 1] with per-image factors (B,) and order (B,) bool."""
    bf = brightness[:, None, None, None]
    cf = contrast[:, None, None, None]

    def apply_brightness(x):
        return _blend(x, torch.zeros_like(x), bf)

    def apply_contrast(x):
        gray = (0.2989 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
                if x.shape[-1] == 3 else x.mean(-1))
        return _blend(x, gray.mean(dim=(1, 2))[:, None, None, None], cf)

    first = brightness_first[:, None, None, None]
    return torch.where(first, apply_contrast(apply_brightness(imgs)),
                       apply_brightness(apply_contrast(imgs)))


def augment_cxr_batch(imgs: torch.Tensor, gen: Optional[torch.Generator],
                      degrees: float = 30.0, shear: float = 15.0, brightness: float = 0.2,
                      contrast: float = 0.2) -> torch.Tensor:
    """(B, H, W, C) -> each image augmented on its own draws: the affine,
    then the jitter."""
    d = augment_draws(imgs.shape[0], gen, degrees, shear, brightness, contrast, imgs.device)
    out = random_affine(imgs, d["angle"], d["shear"])
    return color_jitter(out, d["brightness"], d["contrast"], d["brightness_first"])


def augment_cxr(img: torch.Tensor, gen: Optional[torch.Generator], degrees: float = 30.0,
                shear: float = 15.0, brightness: float = 0.2,
                contrast: float = 0.2) -> torch.Tensor:
    """One (H, W, C) image: ``augment_cxr_batch`` of a batch of one."""
    return augment_cxr_batch(img[None], gen, degrees, shear, brightness, contrast)[0]
