"""Multi-head attention primitives (port of radialog_tpu/ops/attention.py).

Scores and softmax in fp32, additive bias masks. Layouts as in the JAX
package: q (B,T,H,D), k/v (B,S,H,D).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # large negative, safe in bf16/fp32 softmax


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        scale: Optional[float] = None) -> torch.Tensor:
    """Returns (B, T, H, D) in q.dtype."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def mha_shared_prefix(q: torch.Tensor, k0: torch.Tensor, v0: torch.Tensor,
                      k1: torch.Tensor, v1: torch.Tensor,
                      bias1: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Attention over [shared prefix | per-sequence region] with one softmax.
    q (B,T,H,D); k0/v0 (P0,H,D) shared by every row; k1/v1 (B,S1,H,D);
    bias1 masks only the per-sequence region."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    qf = q.float()
    s0 = torch.einsum("bthd,phd->bhtp", qf, k0.float()) * scale
    s1 = torch.einsum("bthd,bshd->bhts", qf, k1.float()) * scale
    if bias1 is not None:
        s1 = s1 + bias1.float()
    p = torch.softmax(torch.cat([s0, s1], dim=-1), dim=-1)
    p0, p1 = p[..., :k0.shape[0]], p[..., k0.shape[0]:]
    out = (torch.einsum("bhtp,phd->bthd", p0.to(v0.dtype).float(), v0.float())
           + torch.einsum("bhts,bshd->bthd", p1.to(v1.dtype).float(), v1.float()))
    return out.to(q.dtype)


def causal_mask_bias(q_len: int, kv_len: int, offset: int = 0, device=None,
                     dtype=torch.float32) -> torch.Tensor:
    """(1,1,q_len,kv_len): query i (position offset+i) attends kv j <= offset+i."""
    qi = torch.arange(q_len, device=device)[:, None] + offset
    kj = torch.arange(kv_len, device=device)[None, :]
    return torch.where(kj <= qi, 0.0, NEG_INF).to(dtype)[None, None]


def padding_mask_bias(valid: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """valid: (B, S) — 1 for real tokens. Returns (B,1,1,S)."""
    return torch.where(valid.bool(), 0.0, NEG_INF).to(dtype)[:, None, None, :]


def combine_bias(*biases: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    out = None
    for b in biases:
        if b is None:
            continue
        out = b if out is None else out + b
    return out
