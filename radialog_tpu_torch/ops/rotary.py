"""Rotary position embeddings, LLaMA "half" layout (port of
radialog_tpu/ops/rotary.py)."""
from __future__ import annotations

import torch


def rope_tables(head_dim: int, max_len: int, theta: float = 10000.0, device=None):
    """(cos, sin) tables of shape (max_len, head_dim), float32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x (B,T,H,D); cos/sin (max_len, D); positions (B,T)."""
    c = cos[positions.long()][:, :, None, :]
    s = sin[positions.long()][:, :, None, :]
    xf = x.float()
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)
