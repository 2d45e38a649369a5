"""Causal, length-masked attention with an online softmax (flash
attention), forward and backward, for prefills without a cache and for
training.

Port of radialog_tpu/ops/flash_attention.py (``_fwd_kernel``, ``_dq_kernel``
and ``_dkv_kernel`` through ``_flash_attention_jit`` and its custom VJP). On
a CUDA tensor the wrappers launch the hand-written kernels: K3
(csrc/flash_attention.cu) forward, K5a and K5b (csrc/flash_attention_bwd.cu)
backward. On a CPU tensor they run the plain PyTorch versions
``flash_attention_plain`` and ``flash_attention_bwd_plain``, which walk the
JAX package's blocks (bq = min(256, T), bk = min(256, S), zero padding to
block multiples) with the same online update and the same recomputation.
``flash_attention`` is differentiable in q, k and v on both devices through
a ``torch.autograd.Function`` over these: no gradient comes from autograd
through the plain forward.

The math:
  s = (q . k in f32) * scale, masked to -1e30 where k_pos >= length (and
      k_pos > q_pos when causal); queries at or past the length attend the
      valid keys
  online softmax in f32; p is rounded to the input dtype before p @ v,
  f32 sums; out = acc / max(l, 1e-30) in q's dtype; lse = m + log(l)
  a lane of length 0 emits zeros and lse = LSE_DEAD (what the JAX
  docstring states; its arithmetic gives the mean of the zero-padded V
  blocks there, which no caller reaches)

The backward (FlashAttention-2 style), from the saved out and lse:
  delta = rowsum(do * out) in f32 (the JAX package leaves it to XLA; on the
      card's TMA route, bf16 at D 64/128, K5a computes it as it starts, and
      elsewhere it is a PyTorch reduction)
  p  = exp(s - lse) where the key is valid, exactly 0 elsewhere (so a row
      with lse = LSE_DEAD, and a lane of length 0, give zero gradients)
  dp = do . v in f32; ds = (p * (dp - delta) * scale) rounded to q's dtype
  dq = sum over keys of ds . k (K5a); dv = sum over queries of p^T . do with
      p rounded to do's dtype, dk = sum over queries of ds^T . q (K5b); f32
      sums, results in the input dtype; rows of k/v past the length get 0

Lengths above S are clamped to S.
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
TMA_HEAD_DIMS = (64, 128)   # the head dims of K3's TMA + wgmma kernel
TQ, TK = 128, 128           # its query rows per block and key rows per stage
BQ_MMA = 64                 # query rows per block of the mma.sync and f32 kernels


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


def _route(dtype: torch.dtype, d: int) -> str:
    """The kernel K3 launches (the C side chooses it the same way): "tma"
    (bf16 with D in TMA_HEAD_DIMS: TMA + wgmma), "mma" (bf16 at other head
    dims, as the mock's D = 16: an mma.sync kernel) or "fma" (f32)."""
    if dtype == torch.float32:
        return "fma"
    return "tma" if d in TMA_HEAD_DIMS else "mma"


def _grid(b: int, t: int, h: int, route: str):
    """K3's grid: (query tiles, heads, lanes); a block holds TQ query rows
    on the "tma" route and BQ_MMA on the others."""
    return (-(-t // (TQ if route == "tma" else BQ_MMA)), h, b)


def _strides(x: torch.Tensor):
    """Batch, token and head strides of a (B, T, H, D) tensor for the
    kernel; a dim of size 1 gets the stride a dense layout would give it,
    which TMA takes (its strides are 16-byte multiples) and no index reads."""
    b, t, h, d = x.shape
    sb, st, sh = x.stride()[:3]
    sh = d if h == 1 else sh
    st = h * sh if t == 1 else st
    sb = t * st if b == 1 else sb
    return sb, st, sh


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
            *_strides(q), *_strides(k), *_strides(v), int(causal), scale,
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_kernel.launches += 1
    _build.check(rc, "flash_attention_fwd_launch")
    return (out, lse) if with_lse else out


flash_attention_kernel.launches = 0


# ------------------------------------------------------------------ backward
def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do * out) in f32, (B,T,H,D) -> (B,H,T)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_blocks(q, k, v, lengths, lse, delta, do, causal, scale, bq, bk):
    """The blocks both plain backward passes walk: yields, per (query block,
    key block), the row and column slices and the block's p (f32), ds
    (rounded to q's dtype, as f32), with q/k/v/do as padded (B,H,*,D) f32."""
    b, t, h, d = q.shape
    s_len = k.shape[1]
    bq, bk = min(bq, t), min(bk, s_len)
    tp, sp = -(-t // bq) * bq, -(-s_len // bk) * bk
    dev = q.device
    qt = F.pad(q, (0, 0, 0, 0, 0, tp - t)).transpose(1, 2).float()
    ot = F.pad(do, (0, 0, 0, 0, 0, tp - t)).transpose(1, 2).float()
    kt = F.pad(k, (0, 0, 0, 0, 0, sp - s_len)).transpose(1, 2).float()
    vt = F.pad(v, (0, 0, 0, 0, 0, sp - s_len)).transpose(1, 2).float()
    lse_p = F.pad(lse.float(), (0, tp - t), value=LSE_DEAD)[..., None]
    delta_p = F.pad(delta.float(), (0, tp - t))[..., None]
    lens = torch.clamp(lengths.to(device=dev, dtype=torch.long), max=s_len)[:, None, None, None]

    def block(qi, ki):
        rows, cols = slice(qi * bq, (qi + 1) * bq), slice(ki * bk, (ki + 1) * bk)
        q_pos = torch.arange(qi * bq, (qi + 1) * bq, device=dev)[:, None]
        k_pos = torch.arange(ki * bk, (ki + 1) * bk, device=dev)[None, :]
        mask = k_pos < lens
        if causal:
            mask = mask & (k_pos <= q_pos)
        s = torch.matmul(qt[:, :, rows], kt[:, :, cols].transpose(-1, -2)) * scale
        p = torch.where(mask, torch.exp(torch.where(mask, s, torch.full_like(s, NEG_INF))
                                        - lse_p[:, :, rows]), torch.zeros_like(s))
        dp = torch.matmul(ot[:, :, rows], vt[:, :, cols].transpose(-1, -2))
        ds = (p * (dp - delta_p[:, :, rows]) * scale).to(q.dtype).float()
        return rows, cols, p, ds

    return (qt, kt, ot), (tp // bq, sp // bk), block


def flash_attention_dq_plain(q, k, v, lengths, lse, delta, do, causal: bool = True,
                             scale: Optional[float] = None, bq: int = 256, bk: int = 256):
    """Plain version of K5a: dq (B,T,H,D) in q's dtype. lse, delta (B,H,T)."""
    t, d = q.shape[1], q.shape[3]
    scale = float(scale if scale is not None else d ** -0.5)
    (qt, kt, _), (nq, nk), block = _bwd_blocks(q, k, v, lengths, lse, delta, do, causal,
                                               scale, bq, bk)
    dq = torch.zeros_like(qt)
    for qi in range(nq):
        for ki in range(nk):
            rows, cols, _, ds = block(qi, ki)
            dq[:, :, rows] += torch.matmul(ds, kt[:, :, cols])
    return dq.transpose(1, 2)[:, :t].to(q.dtype)


def flash_attention_dkv_plain(q, k, v, lengths, lse, delta, do, causal: bool = True,
                              scale: Optional[float] = None, bq: int = 256, bk: int = 256):
    """Plain version of K5b: (dk, dv), each (B,S,H,D) in k's dtype."""
    s_len, d = k.shape[1], q.shape[3]
    scale = float(scale if scale is not None else d ** -0.5)
    (qt, kt, ot), (nq, nk), block = _bwd_blocks(q, k, v, lengths, lse, delta, do, causal,
                                                scale, bq, bk)
    dk, dv = torch.zeros_like(kt), torch.zeros_like(kt)
    for ki in range(nk):
        for qi in range(nq):
            rows, cols, p, ds = block(qi, ki)
            dv[:, :, cols] += torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                                           ot[:, :, rows])
            dk[:, :, cols] += torch.matmul(ds.transpose(-1, -2), qt[:, :, rows])
    return (dk.transpose(1, 2)[:, :s_len].to(k.dtype),
            dv.transpose(1, 2)[:, :s_len].to(v.dtype))


def flash_attention_bwd_plain(q, k, v, lengths, out, lse, do, causal: bool = True,
                              scale: Optional[float] = None, bq: int = 256, bk: int = 256):
    """Plain version of the whole backward: (dq, dk, dv) from the forward's
    out and lse and the output's gradient do."""
    delta = _delta(out, do)
    dq = flash_attention_dq_plain(q, k, v, lengths, lse, delta, do, causal, scale, bq, bk)
    dk, dv = flash_attention_dkv_plain(q, k, v, lengths, lse, delta, do, causal, scale, bq, bk)
    return dq, dk, dv


def flash_attention_dq_delta_plain(q, k, v, lengths, lse, out, do, causal: bool = True,
                                   scale: Optional[float] = None, bq: int = 256, bk: int = 256):
    """Plain version of K5a with delta folded in: (dq, delta) from the
    forward's out instead of delta, delta = rowsum(do * out) (B,H,T) f32."""
    delta = _delta(out, do)
    return flash_attention_dq_plain(q, k, v, lengths, lse, delta, do, causal, scale, bq,
                                    bk), delta


BWD_HEAD_DIMS = (16, 32, 64, 128)
BWD_ROWS = 64     # owned rows a block of K5a (queries) and K5b (keys), every route


# K5a and K5b choose their kernels as K3 does (and the C side the same way):
# "tma" dq_tma, dkv_tma; "mma" dq_bf16, dkv_bf16; "fma" dq_f32, dkv_f32
_bwd_route = _route


def _bwd_grid(kind: str, b: int, t: int, s: int, h: int, route: str):
    """K5a's (kind "dq": query tiles of T) or K5b's ("dkv": key tiles of S)
    grid, BWD_ROWS rows a tile. The TMA route: (heads, lanes, tiles), the
    tile index slowest, so that the heavy tiles of every head and lane start
    first (``_bwd_tile_order``); the other routes: (tiles, heads, lanes)."""
    tiles = -(-(t if kind == "dq" else s) // BWD_ROWS)
    return (h, b, tiles) if route == "tma" else (tiles, h, b)


def _bwd_tile_order(kind: str, tiles: int):
    """The tile each blockIdx.z takes on the TMA route: K5a the last query
    tiles first (under causal masking they have the most keys), K5b the
    first key tiles first (the most queries)."""
    return list(range(tiles - 1, -1, -1)) if kind == "dq" else list(range(tiles))


def _bwd_blocks_per_sm(kind: str, d: int) -> int:
    """Blocks of K5a's (kind "dq") or K5b's ("dkv") TMA kernel at head dim
    d that one SM of the current card holds at once (the design's two)."""
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    n = fn(d, int(kind == "dkv"))
    if n < 0:
        _build.check(-n, "flash_attention_bwd_blocks_per_sm")
    return n


def _tma_ok(x: torch.Tensor) -> bool:
    """A TMA map reads x through its strides: rows 16-byte aligned and no
    broadcast (stride 0) dim, as autograd hands over the gradient of a sum."""
    return _strided_ok(x) and all(st > 0 for st, n in zip(x.stride(), x.shape) if n > 1)


def _bwd_launch(kind: str, q, k, v, lengths, lse, delta, do, causal, scale, outs, out=None):
    """Checks shared by K5a and K5b, then the launch of K5a (kind "dq") or
    K5b ("dkv"). With ``out`` (K5a on the TMA route), delta is written."""
    b, t, h, d = q.shape
    s_len = k.shape[1]
    if (k.shape != (b, s_len, h, d) or v.shape != k.shape or do.shape != q.shape
            or lengths.shape != (b,) or lse.shape != (b, h, t) or delta.shape != (b, h, t)
            or (out is not None and out.shape != q.shape)):
        raise ValueError(f"K5 shapes do not fit: q {q.shape} k {k.shape} v {v.shape} do "
                         f"{do.shape} lengths {lengths.shape} lse {lse.shape} delta "
                         f"{delta.shape}")
    if q.dtype not in (torch.bfloat16, torch.float32) or any(
            x.dtype != q.dtype for x in (k, v, do) + (() if out is None else (out,))):
        raise ValueError(f"K5 takes bf16 or f32 q/k/v/do of one dtype: {q.dtype} {k.dtype} "
                         f"{v.dtype} {do.dtype}")
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"K5 is built for head_dim in {BWD_HEAD_DIMS}: {d}")
    route = _bwd_route(q.dtype, d)
    if out is not None and route != "tma":
        raise ValueError(f"K5a computes delta only on the TMA route, not {route}")
    for x in (q, k, v, do, lengths, lse, delta) + (() if out is None else (out,)):
        if not (x.is_cuda and x.device == q.device):
            raise ValueError("K5 takes CUDA tensors on one device")
    ok = _tma_ok if route == "tma" else _strided_ok
    q, k, v, do = (x if ok(x) else x.contiguous() for x in (q, k, v, do))
    if out is not None and not _strided_ok(out):
        out = out.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    lse = lse.float().contiguous()
    if out is None:
        delta = delta.float().contiguous()
    scale = float(scale if scale is not None else d ** -0.5)
    strides = (ctypes.c_longlong * 15)(*_strides(q), *_strides(k), *_strides(v), *_strides(do),
                                       *(_strides(out) if out is not None else (0, 0, 0)))
    fn = getattr(_build.load("flash_attention_bwd"), f"flash_attention_{kind}_launch")
    fn.argtypes = ([ctypes.c_void_p] * (7 + len(outs)) + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p]
                   + ([ctypes.c_void_p] if kind == "dq" else []))
    fn.restype = ctypes.c_int
    extra = (None if out is None else out.data_ptr(),) if kind == "dq" else ()
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), lens.data_ptr(), *(o.data_ptr() for o in outs), b, t, s_len, h,
              d, strides, int(causal), scale, int(q.dtype == torch.bfloat16),
              torch.cuda.current_stream(q.device).cuda_stream, *extra)


def flash_attention_dq_kernel(q, k, v, lengths, lse, delta, do, causal: bool = True,
                              scale: Optional[float] = None):
    """K5a on the card; same signature and result as ``flash_attention_dq_plain``.
    q/k/v/do are read through their strides."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rc = _bwd_launch("dq", q, k, v, lengths, lse, delta, do, causal, scale, (dq,))
    flash_attention_dq_kernel.launches += 1
    _build.check(rc, "flash_attention_dq_launch")
    return dq


def flash_attention_dq_delta_kernel(q, k, v, lengths, lse, out, do, causal: bool = True,
                                    scale: Optional[float] = None):
    """K5a with delta folded in (the TMA route only); same signature and
    result as ``flash_attention_dq_delta_plain``: (dq, delta). Counts as a
    launch of K5a (``flash_attention_dq_kernel.launches``)."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    rc = _bwd_launch("dq", q, k, v, lengths, lse, delta, do, causal, scale, (dq,), out=out)
    flash_attention_dq_kernel.launches += 1
    _build.check(rc, "flash_attention_dq_launch")
    return dq, delta


def flash_attention_dkv_kernel(q, k, v, lengths, lse, delta, do, causal: bool = True,
                               scale: Optional[float] = None):
    """K5b on the card; same signature and result as ``flash_attention_dkv_plain``."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    rc = _bwd_launch("dkv", q, k, v, lengths, lse, delta, do, causal, scale, (dk, dv))
    flash_attention_dkv_kernel.launches += 1
    _build.check(rc, "flash_attention_dkv_launch")
    return dk, dv


flash_attention_dq_kernel.launches = 0
flash_attention_dkv_kernel.launches = 0


def flash_attention_bwd_kernel(q, k, v, lengths, out, lse, do, causal: bool = True,
                               scale: Optional[float] = None):
    """The whole backward on the card: K5a then K5b. On the TMA route K5a
    computes delta itself; on the others a PyTorch reduction does first."""
    if _bwd_route(q.dtype, q.shape[3]) == "tma":
        dq, delta = flash_attention_dq_delta_kernel(q, k, v, lengths, lse, out, do, causal,
                                                    scale)
    else:
        delta = _delta(out, do)
        dq = flash_attention_dq_kernel(q, k, v, lengths, lse, delta, do, causal, scale)
    dk, dv = flash_attention_dkv_kernel(q, k, v, lengths, lse, delta, do, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """out, lse = forward(q, k, v, lengths); the gradient of out reaches q, k
    and v through K5a/K5b on a card and their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, scale):
        fwd = flash_attention_kernel if q.is_cuda else flash_attention_plain
        out, lse = fwd(q, k, v, lengths, causal=causal, scale=scale, with_lse=True)
        ctx.save_for_backward(q, k, v, lengths, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, lengths, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_kernel if q.is_cuda else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, lengths, out, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, causal: bool = True,
                    scale: Optional[float] = None, with_lse: bool = False):
    """q (B,T,H,D); k/v (B,S,H,D); lengths (B,) valid kv lengths. Returns
    (B,T,H,D) in q.dtype, and with ``with_lse`` also lse (B,H,T) f32. The
    kernels on a CUDA tensor, the plain versions on a CPU tensor.
    Differentiable in q, k and v."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, lengths, causal, scale)
        return (out, lse) if with_lse else out
    fn = flash_attention_kernel if q.is_cuda else flash_attention_plain
    return fn(q, k, v, lengths, causal=causal, scale=scale, with_lse=with_lse)
