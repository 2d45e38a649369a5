"""Vision-transformer pooler fusing current + prior patch grids (port of
radialog_tpu/models/vit_pooler.py, inference only). RaDialog never passes
a prior image, so the main path does not run it; BioViL-T takes it when a
prior is given."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..ops.attention import mha
from ..ops.layers import (DTypePolicy, FP32, gelu_exact, layernorm, layernorm_init,
                          linear, linear_init, normal)


def sine_position_embedding(grid: Tuple[int, int], dim_per_axis: int = 128,
                            temperature: float = 10000.0,
                            scale: float = 2 * math.pi, device=None) -> torch.Tensor:
    """DETR sine/cos table, (H*W, 2*dim_per_axis)."""
    h, w = grid
    y = torch.cumsum(torch.ones((h, w), device=device), dim=0)
    x = torch.cumsum(torch.ones((h, w), device=device), dim=1)
    y = y / (y[-1:, :] + 1e-6) * scale
    x = x / (x[:, -1:] + 1e-6) * scale
    i = torch.arange(dim_per_axis, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.floor(i / 2) / dim_per_axis)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = torch.stack([torch.sin(px[..., 0::2]), torch.cos(px[..., 1::2])], dim=-1).reshape(h, w, -1)
    py = torch.stack([torch.sin(py[..., 0::2]), torch.cos(py[..., 1::2])], dim=-1).reshape(h, w, -1)
    return torch.cat([py, px], dim=-1).reshape(h * w, 2 * dim_per_axis)


def vit_pooler_init(gen, device, dim: int = 256, grid: Tuple[int, int] = (14, 14),
                    num_blocks: int = 3) -> Dict:
    blocks = []
    for _ in range(num_blocks):
        blocks.append({
            "norm1": layernorm_init(dim, device),
            "q": linear_init(gen, dim, dim, device, bias=False),
            "k": linear_init(gen, dim, dim, device, bias=False),
            "v": linear_init(gen, dim, dim, device, bias=False),
            "proj": linear_init(gen, dim, dim, device),
            "norm2": layernorm_init(dim, device),
            "fc1": linear_init(gen, dim, dim, device),
            "fc2": linear_init(gen, dim, dim, device),
        })
    return {"blocks": blocks, "norm_post": layernorm_init(dim, device),
            "type_embed": normal(gen, (2, dim), 0.02, device),
            "_pos": sine_position_embedding(grid, dim // 2, device=device)}


def _block(p, x, emb, num_heads: int, policy: DTypePolicy) -> torch.Tensor:
    b, n, c = x.shape
    hd = c // num_heads
    xe = layernorm(p["norm1"], x, eps=1e-6) + emb
    q = linear(p["q"], xe, policy).reshape(b, n, num_heads, hd)
    k = linear(p["k"], xe, policy).reshape(b, n, num_heads, hd)
    v = linear(p["v"], xe, policy).reshape(b, n, num_heads, hd)
    x = x + linear(p["proj"], mha(q, k, v).reshape(b, n, c), policy)
    h = gelu_exact(linear(p["fc1"], layernorm(p["norm2"], x, eps=1e-6), policy))
    return x + linear(p["fc2"], h, policy)


def vit_pooler_apply(p: Dict, current: torch.Tensor,
                     previous: Optional[torch.Tensor] = None,
                     num_heads: int = 8, policy: DTypePolicy = FP32) -> torch.Tensor:
    """current/previous (B,H,W,C) -> fused current grid (B,H,W,C)."""
    b, h, w, c = current.shape
    n = h * w
    x = current.reshape(b, n, c)
    pos = p["_pos"][None].to(x.dtype)
    emb = pos + p["type_embed"][0][None, None, :]
    if previous is not None:
        x = torch.cat([x, previous.reshape(b, n, c)], dim=1)
        emb = torch.cat([emb, pos + p["type_embed"][1][None, None, :]], dim=1)
    for bp in p["blocks"]:
        x = _block(bp, x, emb, num_heads, policy)
    x = layernorm(p["norm_post"], x, eps=1e-6)
    return x[:, :n].reshape(b, h, w, c)
