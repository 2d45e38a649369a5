"""Causal, length-masked attention forward with an online softmax (flash
attention), for prefills without a cache.

Port of the forward of radialog_tpu/ops/flash_attention.py (``_fwd_kernel``
through ``_flash_attention_jit``). On a CUDA tensor the wrapper launches
the hand-written kernel K3 (csrc/flash_attention.cu); on a CPU tensor it
runs the plain PyTorch version ``flash_attention_plain``, which walks the
JAX package's blocks (bq = min(256, T), bk = min(256, S), zero padding to
block multiples) with the same online update.

The math:
  s = (q . k in f32) * scale, masked to -1e30 where k_pos >= length (and
      k_pos > q_pos when causal); queries at or past the length attend the
      valid keys
  online softmax in f32; p is rounded to the input dtype before p @ v,
  f32 sums; out = acc / max(l, 1e-30) in q's dtype; lse = m + log(l)
  a lane of length 0 emits zeros and lse = LSE_DEAD (what the JAX
  docstring states; its arithmetic gives the mean of the zero-padded V
  blocks there, which no caller reaches)

Lengths above S are clamped to S. The backward (K5a/K5b) is not ported.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

NEG_INF = -1e30
LSE_DEAD = 1e30
MAX_HEAD_DIM = 128


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, causal: bool = True,
                          scale: Optional[float] = None, with_lse: bool = False,
                          bq: int = 256, bk: int = 256):
    """Plain version of K3. q (B,T,H,D); k/v (B,S,H,D); lengths (B,).
    Returns out (B,T,H,D) in q.dtype, and with ``with_lse`` also lse
    (B,H,T) f32."""
    b, t, h, d = q.shape
    s_len = k.shape[1]
    scale = float(scale if scale is not None else d ** -0.5)
    bq, bk = min(bq, t), min(bk, s_len)
    tp, sp = -(-t // bq) * bq, -(-s_len // bk) * bk
    dev = q.device
    qt = F.pad(q, (0, 0, 0, 0, 0, tp - t)).transpose(1, 2).float()       # (B,H,Tp,D)
    kt = F.pad(k, (0, 0, 0, 0, 0, sp - s_len)).transpose(1, 2).float()
    vt = F.pad(v, (0, 0, 0, 0, 0, sp - s_len)).transpose(1, 2).float()
    lens = torch.clamp(lengths.to(device=dev, dtype=torch.long), max=s_len)[:, None, None, None]
    out = torch.empty((b, h, tp, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, tp), dtype=torch.float32, device=dev)
    for qi in range(tp // bq):
        rows = slice(qi * bq, (qi + 1) * bq)
        q_pos = torch.arange(qi * bq, (qi + 1) * bq, device=dev)[:, None]
        m = torch.full((b, h, bq, 1), NEG_INF, device=dev)
        l = torch.zeros((b, h, bq, 1), device=dev)
        acc = torch.zeros((b, h, bq, d), device=dev)
        for ki in range(sp // bk):
            cols = slice(ki * bk, (ki + 1) * bk)
            k_pos = torch.arange(ki * bk, (ki + 1) * bk, device=dev)[None, :]
            s = torch.matmul(qt[:, :, rows], kt[:, :, cols].transpose(-1, -2)) * scale
            mask = k_pos < lens
            if causal:
                mask = mask & (k_pos <= q_pos)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vt[:, :, cols])
            m = m_new
        live = l > 0
        out[:, :, rows] = torch.where(live, acc / torch.clamp(l, min=1e-30),
                                      torch.zeros_like(acc))
        lse[:, :, rows] = torch.where(live, m + torch.log(torch.clamp(l, min=1e-30)),
                                      torch.full_like(m, LSE_DEAD))[..., 0]
    o = out.transpose(1, 2)[:, :t].to(q.dtype)
    return (o, lse[..., :t].contiguous()) if with_lse else o


def _strided_ok(x: torch.Tensor) -> bool:
    """The kernel reads rows of D values with 16-byte copies: the last dim
    must be dense and every row start 16-byte aligned."""
    per16 = 16 // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % per16 == 0 for s in x.stride()[:-1]))


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, causal: bool = True,
                           scale: Optional[float] = None, with_lse: bool = False):
    """K3 on the card; same signature and result as the plain version.
    q/k/v are read through their strides (token-major, no transposed
    copies); a tensor whose rows are not 16-byte aligned is made dense."""
    b, t, h, d = q.shape
    s_len = k.shape[1]
    if k.shape != (b, s_len, h, d) or v.shape != k.shape or lengths.shape != (b,):
        raise ValueError(f"K3 shapes do not fit: q {q.shape} k {k.shape} v {v.shape} "
                         f"lengths {lengths.shape}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"K3 takes bf16 or f32 q/k/v of one dtype: {q.dtype} {k.dtype} "
                         f"{v.dtype}")
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"K3 needs head_dim a multiple of 16 up to 128: {d}")
    for x in (q, k, v, lengths):
        if not (x.is_cuda and x.device == q.device):
            raise ValueError("K3 takes CUDA tensors on one device")
    q, k, v = (x if _strided_ok(x) else x.contiguous() for x in (q, k, v))
    lens = lengths.to(torch.int32).contiguous()
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, t, s_len, h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal), scale,
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_kernel.launches += 1
    _build.check(rc, "flash_attention_fwd_launch")
    return (out, lse) if with_lse else out


flash_attention_kernel.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, causal: bool = True,
                    scale: Optional[float] = None, with_lse: bool = False):
    """q (B,T,H,D); k/v (B,S,H,D); lengths (B,) valid kv lengths. Returns
    (B,T,H,D) in q.dtype, and with ``with_lse`` also lse (B,H,T) f32. The
    kernel K3 on a CUDA tensor, the plain version on a CPU tensor."""
    fn = flash_attention_kernel if q.is_cuda else flash_attention_plain
    return fn(q, k, v, lengths, causal=causal, scale=scale, with_lse=with_lse)
