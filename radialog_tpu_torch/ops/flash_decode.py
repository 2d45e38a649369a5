"""Single-token attention over an int8 token-flat KV cache (flash-decode).

Port of radialog_tpu/ops/flash_decode.py ``flash_decode_int8`` in its
static-slot (and per-lane interval) mask mode with the leading shared-prefix
block. On a CUDA tensor the wrapper launches the hand-written kernel K2
(csrc/flash_decode.cu); on a CPU tensor it runs the plain PyTorch version
``flash_decode_int8_plain``, which walks the same blocks in the same order:
the prefix block first, then the lane's slots in blocks of ``bs`` rows.

The math (the TPU kernel's ``_process_block``):
  scores = float(q8 . k8, exact int32) * ks * qs * D^-1/2, masked to -1e30
  online softmax in f32; pv = bf16(p * vs); acc += pv @ bf16(v8) in f32
  out = acc * (1 / max(l, 1e-30))
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
MAX_BS = 256


def resolve_bs(s_len: int, req: int) -> int:
    """Largest divisor of s_len that is <= req and a multiple of 32 (the JAX
    package's rule, so both walk the same blocks); halving when s_len is
    not a multiple of 32."""
    req = min(req, s_len)
    best = 0
    for cand in range(32, req + 1, 32):
        if s_len % cand == 0:
            best = cand
    if best == 0:
        best = req
        while s_len % best:
            best //= 2
    return best


def default_bs(s_len: int) -> int:
    """The JAX package's default: the first of 64/96/128/256 that resolves
    to at least 64 rows."""
    bs = s_len
    for req in (64, 96, 128, 256):
        bs = resolve_bs(s_len, req)
        if bs >= 64:
            break
    return bs


def quantize_q(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-head symmetric int8 of q (B,H,D): (q8 int8, qs (B,H) f32), the
    rounding of the KV cache's quantize_kv at f32 scales."""
    qf = q.float()
    qs = torch.clamp(qf.abs().amax(dim=-1), min=1e-8) / 127.0
    q8 = torch.clamp(torch.round(qf / qs[..., None]), -127, 127).to(torch.int8)
    return q8, qs


def _block(state, q32, qs, scale, kb, ksb, vb, vsb, valid):
    """One online-softmax step over rows R. kb/vb (B|1,R,H,D) int8,
    ksb/vsb (B|1,R,H) f32, valid (B|1,R,1) bool."""
    m, l, acc = state
    dot = (kb.to(torch.int64) * q32[:, None]).sum(-1)              # (B,R,H) exact
    s = dot.float() * ksb * qs[:, None, :] * scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=1))
    alpha = torch.exp(m - m_new)
    p = torch.where(valid, torch.exp(s - m_new[:, None, :]), torch.zeros_like(s))
    l = l * alpha + p.sum(dim=1)
    pv = (p * vsb).to(torch.bfloat16).float()
    o = torch.einsum("brh,brhd->bhd", pv, vb.float().expand(pv.shape[0], -1, -1, -1))
    return m_new, l, acc * alpha[..., None] + o


def flash_decode_int8_plain(q8, qs, k8, ks, v8, vs, masks, layer_idx: int,
                            scale: float, bs: int, shared=None, p0: int = 0):
    """Plain version of K2. q8 (B,H,D) int8, qs (B,H) f32; k8/v8 (L,B,S,H*D)
    int8; ks/vs (L,B,S,SL) with SL >= H; masks = (lens, a1, b1, a2, b2),
    each (B,) int32; shared = (k0, ks0, v0, vs0) one layer's prefix,
    (P0p, H*D) int8 and (P0p, SL0) scales. Returns (B,H,D) f32."""
    b, h, d = q8.shape
    s_len = k8.shape[2]
    dev = q8.device
    q32 = q8.to(torch.int64)
    state = (torch.full((b, h), NEG_INF, device=dev),
             torch.zeros((b, h), device=dev), torch.zeros((b, h, d), device=dev))
    if shared is not None:
        k0, ks0, v0, vs0 = shared
        p0p = k0.shape[0]
        valid = (torch.arange(p0p, device=dev) < p0)[None, :, None]
        state = _block(state, q32, qs, scale, k0.reshape(1, p0p, h, d),
                       ks0[None, :, :h].float(), v0.reshape(1, p0p, h, d),
                       vs0[None, :, :h].float(), valid)
    lens, a1, b1, a2, b2 = masks
    live = int(torch.maximum(torch.maximum(lens - 1, b1), b2).max())
    nblk = 0 if live < 0 else min(live // bs + 1, s_len // bs)
    k_l, v_l = k8[layer_idx], v8[layer_idx]
    ks_l, vs_l = ks[layer_idx], vs[layer_idx]
    for i in range(nblk):
        rows = slice(i * bs, (i + 1) * bs)
        pos = torch.arange(i * bs, (i + 1) * bs, device=dev)[None, :]
        valid = ((pos < lens[:, None]) | ((pos >= a1[:, None]) & (pos <= b1[:, None]))
                 | ((pos >= a2[:, None]) & (pos <= b2[:, None])))[..., None]
        state = _block(state, q32, qs, scale, k_l[:, rows].reshape(b, bs, h, d),
                       ks_l[:, rows, :h].float(), v_l[:, rows].reshape(b, bs, h, d),
                       vs_l[:, rows, :h].float(), valid)
    _, l, acc = state
    return acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]


def flash_decode_int8_kernel(q8, qs, k8, ks, v8, vs, masks, layer_idx: int,
                             scale: float, bs: int, shared=None, p0: int = 0):
    """K2 on the card; same signature and result as the plain version."""
    b, h, d = q8.shape
    n_layers, b2_, s_len, hd = k8.shape
    sl = ks.shape[-1]
    if b2_ != b or hd != h * d or v8.shape != k8.shape or vs.shape != ks.shape:
        raise ValueError(f"cache shapes {k8.shape} {ks.shape} do not fit q {q8.shape}")
    if d % 4 or d > 128 or sl < h:
        raise ValueError(f"K2 needs head_dim % 4 == 0, <= 128 and SL >= H: {d}, {sl}")
    if bs > MAX_BS or s_len % bs or not 0 <= layer_idx < n_layers:
        raise ValueError(f"bad block size {bs} / layer {layer_idx} for S={s_len}")
    if (k8.dtype != torch.int8 or ks.dtype != torch.bfloat16
            or vs.dtype != torch.bfloat16 or q8.dtype != torch.int8):
        raise ValueError("K2 takes an int8 cache with bf16 scales")
    tensors = [q8, qs, k8, ks, v8, vs, *masks]
    if shared is not None:
        tensors += list(shared)
    for t in tensors:
        if not (t.is_cuda and t.is_contiguous() and t.device == q8.device):
            raise ValueError("K2 takes contiguous CUDA tensors on one device")
    if any(m.dtype != torch.int32 for m in masks) or qs.dtype != torch.float32:
        raise ValueError("K2 takes int32 masks and f32 q scales")
    out = torch.empty((b, h, d), dtype=torch.float32, device=q8.device)
    if shared is not None:
        k0, ks0, v0, vs0 = shared
        p0p, sl0 = k0.shape[0], ks0.shape[-1]
        if k0.shape != (p0p, hd) or v0.shape != k0.shape or vs0.shape != ks0.shape \
                or sl0 < h or ks0.dtype != torch.bfloat16 or vs0.dtype != torch.bfloat16:
            raise ValueError(f"bad shared prefix {k0.shape} {ks0.shape}")
        if p0p * (2 * d + 4) + p0p * 18 * 4 + 16 * d > 227 * 1024:   # prefix_smem()
            raise ValueError(f"shared prefix of {p0p} rows does not fit shared memory")
        pm = torch.empty((b, h), dtype=torch.float32, device=q8.device)
        pl = torch.empty_like(pm)
        pacc = torch.empty((b, h, d), dtype=torch.float32, device=q8.device)
        ptrs = [k0.data_ptr(), ks0.data_ptr(), v0.data_ptr(), vs0.data_ptr()]
        extra = [int(p0), p0p, sl0, pm.data_ptr(), pl.data_ptr(), pacc.data_ptr()]
    else:
        ptrs = [None] * 4
        extra = [0, 0, 0, None, None, None]
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_int8_launch
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(q8.data_ptr(), qs.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
            vs.data_ptr(), *[m.data_ptr() for m in masks], *ptrs, *extra, out.data_ptr(),
            layer_idx, b, s_len, h, d, sl, bs, scale,
            torch.cuda.current_stream(q8.device).cuda_stream)
    flash_decode_int8_kernel.launches += 1
    _build.check(rc, "flash_decode_int8_launch")
    return out


flash_decode_int8_kernel.launches = 0


def slot_masks(lengths: torch.Tensor, prompt_pad=None, step=None,
               gen_intervals=None):
    """(lens, a1, b1, a2, b2), each (B,) int32: the static-slot mask
    (a1 = prompt_pad, b1 = prompt_pad + step, empty second interval) or the
    given per-lane intervals."""
    b = lengths.shape[0]
    dev = lengths.device
    lens = lengths.to(torch.int32).contiguous()
    if gen_intervals is None:
        if prompt_pad is None or step is None:
            raise ValueError("give (prompt_pad, step) or gen_intervals")
        a1 = torch.full((b,), int(prompt_pad), dtype=torch.int32, device=dev)
        b1 = torch.full((b,), int(prompt_pad) + int(step), dtype=torch.int32, device=dev)
        a2 = torch.zeros((b,), dtype=torch.int32, device=dev)
        b2 = torch.full((b,), -1, dtype=torch.int32, device=dev)
        return lens, a1, b1, a2, b2
    return (lens,) + tuple(torch.as_tensor(x, dtype=torch.int32, device=dev).contiguous()
                           for x in gen_intervals)


def flash_decode_int8(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                      v8: torch.Tensor, vs: torch.Tensor, lengths: torch.Tensor,
                      prompt_pad=None, step=None, layer_idx: int = 0,
                      scale: Optional[float] = None, bs: Optional[int] = None,
                      shared=None, p0=None, gen_intervals=None) -> torch.Tensor:
    """Single-token attention over layer ``layer_idx`` of the stacked int8
    cache. q (B,H,D) float; k8/v8 (L,B,S,H*D) int8; ks/vs (L,B,S,SL) bf16
    with SL >= H; lengths (B,) prompt-region lengths; (prompt_pad, step) the
    static-slot mask or gen_intervals (a1, b1, a2, b2) per lane; shared =
    (k0, ks0, v0, vs0) one layer's int8 prefix with p0 live rows. Returns
    (B,H,D) in q.dtype."""
    h, d = q.shape[1], q.shape[2]
    s_len = k8.shape[2]
    scale = float(scale if scale is not None else d ** -0.5)
    bs = default_bs(s_len) if bs is None else resolve_bs(s_len, bs)
    q8, qs = quantize_q(q)
    masks = slot_masks(lengths, prompt_pad, step, gen_intervals)
    fn = flash_decode_int8_kernel if q.is_cuda else flash_decode_int8_plain
    out = fn(q8, qs, k8, ks, v8, vs, masks, layer_idx, scale, bs,
             shared=shared, p0=0 if p0 is None else int(p0))
    return out.to(q.dtype)
