"""Single-token attention over an int8 token-flat KV cache (flash-decode).

Port of radialog_tpu/ops/flash_decode.py ``flash_decode_int8`` in its
static-slot (and per-lane interval) mask mode with the leading shared-prefix
block, and in its ``current`` / ``write_cache`` mode. On a CUDA tensor the
wrapper launches the hand-written kernel of csrc/flash_decode.cu; on a CPU
tensor it runs the plain PyTorch version ``flash_decode_int8_plain``, which
walks the same blocks in the same order: the prefix block first, then the
current row, then the lane's slots in blocks of ``bs`` rows. Each mode has
its own wrapper and launch count: ``flash_decode_int8_kernel`` (K2, and K2'
with per-lane intervals), ``flash_decode_int8_current_kernel`` (K2'': the
step's own K/V row as an operand, written into the cache in place with
``write_cache``) and ``flash_decode_int8_fused_kernel`` (T1, the prototype
of tools/microbench_kvfused.py: K2 over one interleaved k|v buffer).

The math (the TPU kernel's ``_process_block``):
  scores = float(q8 . k8, exact int32) * ks * qs * D^-1/2, masked to -1e30
  online softmax in f32; pv = bf16(p * vs); acc += pv @ bf16(v8) in f32
  out = acc * (1 / max(l, 1e-30))

On the card a call is one launch of csrc/flash_decode.cu's ``lane_kernel``,
behind one of ``prefix_kernel`` where a shared prefix has live rows. How the
kernels cover the cache (``_plan``: splits of a (head, lane) over a
thread-block cluster, the loads of a row; ``_prefix_plan``: tiles of the
prefix) is a function of the shapes alone; the wrapper never reads the
lengths or intervals on the host. The kernels compute every p and pv
against the plain version's own running max (the prefix's, then block by
block of ``bs`` slots), so only the order of the f32 sums differs: they
agree with the plain version to a few ulp, well within K2's tolerance, and
repeat themselves bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
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


def _current_block(state, q32, qs, scale, current, h: int, d: int):
    """The step's own K/V row: kc/vc (B,1,H*D) int8, kcs/vcs (B,1,SLc)."""
    kc, kcs, vc, vcs = current
    b = kc.shape[0]
    valid = torch.ones((1, 1, 1), dtype=torch.bool, device=kc.device)
    return _block(state, q32, qs, scale, kc.reshape(b, 1, h, d), kcs[..., :h].float(),
                  vc.reshape(b, 1, h, d), vcs[..., :h].float(), valid)


def flash_decode_int8_plain(q8, qs, k8, ks, v8, vs, masks, layer_idx: int,
                            scale: float, bs: int, shared=None, p0: int = 0,
                            current=None, write_cache: bool = False):
    """Plain version of K2, K2' and K2''. q8 (B,H,D) int8, qs (B,H) f32;
    k8/v8 (L,B,S,H*D) int8; ks/vs (L,B,S,SL) with SL >= H; masks = (lens,
    a1, b1, a2, b2), each (B,) int32; shared = (k0, ks0, v0, vs0) one
    layer's prefix, (P0p, H*D) int8 and (P0p, SL0) scales; current = (kc,
    kcs, vc, vcs) the step's own row, (B,1,H*D) int8 and (B,1,SLc) scales,
    attended after the prefix and before the lane's blocks; write_cache
    stores it at slot b1 + 1 of each lane in layer ``layer_idx``, in place,
    and nothing else. A block of ``bs`` slots where no lane has a valid slot
    is not walked, which changes nothing: it would leave (m, l, acc) as they
    were (m_new = m, alpha = 1, p = 0). Returns (B,H,D) f32."""
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
    if current is not None:
        state = _current_block(state, q32, qs, scale, current, h, d)
    lens, a1, b1, a2, b2 = masks
    pos = torch.arange(s_len, device=dev)[None, :]
    valid = ((pos < lens[:, None]) | ((pos >= a1[:, None]) & (pos <= b1[:, None]))
             | ((pos >= a2[:, None]) & (pos <= b2[:, None])))[..., None]       # (B,S,1)
    nblk = s_len // bs
    walk = valid.reshape(b, nblk, bs).any(dim=2).any(dim=0).tolist()
    k_l, v_l = k8[layer_idx], v8[layer_idx]
    ks_l, vs_l = ks[layer_idx], vs[layer_idx]
    for i in range(nblk):
        if not walk[i]:
            continue
        rows = slice(i * bs, (i + 1) * bs)
        state = _block(state, q32, qs, scale, k_l[:, rows].reshape(b, bs, h, d),
                       ks_l[:, rows, :h].float(), v_l[:, rows].reshape(b, bs, h, d),
                       vs_l[:, rows, :h].float(), valid[:, rows])
    _, l, acc = state
    if write_cache:
        kc, kcs, vc, vcs = current
        lane = torch.arange(b, device=dev)
        slot = b1.long() + 1
        k8[layer_idx, lane, slot] = kc[:, 0]
        v8[layer_idx, lane, slot] = vc[:, 0]
        ks[layer_idx, lane, slot] = kcs[:, 0]
        vs[layer_idx, lane, slot] = vcs[:, 0]
    return acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]


_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7
             + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_void_p])

SMS = 132              # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 8      # lane-kernel blocks an SM holds (csrc/flash_decode.cu LANE_BLOCKS)
MAX_SPLITS = 8         # the portable thread-block cluster size
WARPS, CHUNK = 4, 16   # a lane-kernel block's warps, and the rows a warp loads at once
PREFIX_TILE = 64       # prefix rows of a prefix-kernel block


@dataclasses.dataclass(frozen=True)
class Plan:
    """How csrc/flash_decode.cu's ``lane_kernel`` covers the cache: each
    (head, lane) is a cluster of ``splits`` blocks, split i over the ``per``
    blocks of ``bs`` slots from i * per; each of the ``warps`` warps of a
    block takes ``chunk``-row chunks in turn, ``tpr`` threads a head row,
    ``vec`` bytes each (16, or 4 where D % 16 != 0)."""
    splits: int
    per: int
    bs: int
    warps: int
    vec: int
    tpr: int
    chunk: int


@functools.lru_cache(maxsize=None)
def _plan(b: int, h: int, d: int, s_len: int, bs: int) -> Plan:
    """The lane kernel's plan, a function of the shapes alone (never of the
    lengths or intervals, which stay on the card): split a (head, lane)'s
    S / bs blocks of slots over as many blocks (at most MAX_SPLITS, never an
    empty one) as it takes for B * H * splits to reach BLOCKS_PER_SM blocks
    on each of the SMS multiprocessors. A split past a lane's live bound
    reads nothing and leaves the empty state, which merges exactly."""
    nblk = s_len // bs
    want = -(-SMS * BLOCKS_PER_SM // (b * h))
    splits = max(1, min(MAX_SPLITS, nblk, want))
    per = -(-nblk // splits)
    splits = -(-nblk // per)
    vec = 16 if d % 16 == 0 else 4
    tpr = 1
    while tpr * vec < d:
        tpr *= 2
    rows = 32 // tpr
    return Plan(splits=splits, per=per, bs=bs, warps=WARPS, vec=vec, tpr=tpr,
                chunk=max(rows, CHUNK))


def _prefix_plan(p0: int) -> Tuple[int, int]:
    """prefix_kernel's (tiles, sub-tiles a tile) over the p0 live prefix rows,
    in sub-tiles of PREFIX_TILE rows: at most MAX_SPLITS tiles, one cluster
    per (head, group of 16 lanes), so that the tiles can share the prefix's
    max score. No tile for p0 = 0 (rows past p0 are masked)."""
    n = -(-int(p0) // PREFIX_TILE)
    sub = max(1, -(-n // MAX_SPLITS))
    return -(-n // sub), sub


def _aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch(q8, qs, k, ks, v, vs, masks, layer_idx: int, scale: float, bs: int,
            n_layers: int, s_len: int, kv_stride: int, sl: int, shared=None, p0: int = 0,
            current=None, write: bool = False) -> Tuple[int, torch.Tensor]:
    """Checks what every mode of the kernel shares and launches it on q8's
    stream: k/v hold the layer's rows kv_stride bytes apart, ks/vs its
    scales sl elements apart (k, ks, v, vs are tensors whose data pointers
    are the first row's). One launch, two with a live shared prefix; no
    read of the masks on the host. Returns (CUDA error code, out (B,H,D)
    f32)."""
    b, h, d = q8.shape
    if d % 4 or d > 128 or sl < h:
        raise ValueError(f"K2 needs head_dim % 4 == 0, <= 128 and SL >= H: {d}, {sl}")
    if bs > MAX_BS or s_len % bs or not 0 <= layer_idx < n_layers:
        raise ValueError(f"bad block size {bs} / layer {layer_idx} for S={s_len}")
    if (k.dtype != torch.int8 or v.dtype != torch.int8 or ks.dtype != torch.bfloat16
            or vs.dtype != torch.bfloat16 or q8.dtype != torch.int8):
        raise ValueError("K2 takes an int8 cache with bf16 scales")
    tensors = [q8, qs, *masks] + list(shared or ()) + list(current or ())
    for t in tensors:
        if not (t.is_cuda and t.is_contiguous() and t.device == q8.device):
            raise ValueError("K2 takes contiguous CUDA tensors on one device")
    for t in (k, ks, v, vs):
        if not t.is_cuda or t.device != q8.device:
            raise ValueError("K2 takes its cache on q's device")
    if any(m.dtype != torch.int32 or m.shape != (b,) for m in masks) \
            or qs.dtype != torch.float32:
        raise ValueError("K2 takes (B,) int32 masks and f32 q scales")
    plan = _plan(b, h, d, s_len, bs)
    # 16-byte loads need every row segment (q, K, V, the prefix) 16-byte aligned
    aligned = kv_stride % 16 == 0 and _aligned16(q8, k, v, *(shared or ())[::2])
    vec = plan.vec if aligned else 4
    out = torch.empty((b, h, d), dtype=torch.float32, device=q8.device)
    tiles = 0
    if shared is not None:
        k0, ks0, v0, vs0 = shared
        p0p, sl0 = k0.shape[0], ks0.shape[-1]
        if k0.shape != (p0p, h * d) or v0.shape != k0.shape or vs0.shape != ks0.shape \
                or sl0 < h or ks0.dtype != torch.bfloat16 or vs0.dtype != torch.bfloat16:
            raise ValueError(f"bad shared prefix {k0.shape} {ks0.shape}")
        tiles, sub = _prefix_plan(min(p0, p0p))
    if tiles:
        pm = torch.empty((tiles, b, h), dtype=torch.float32, device=q8.device)
        pl = torch.empty_like(pm)
        pacc = torch.empty((tiles, b, h, d), dtype=torch.float32, device=q8.device)
        pre = [k0.data_ptr(), ks0.data_ptr(), v0.data_ptr(), vs0.data_ptr(), min(p0, p0p), p0p,
               sl0, tiles, sub, pm.data_ptr(), pl.data_ptr(), pacc.data_ptr()]
    else:
        pre = [None] * 4 + [0] * 5 + [None] * 3
    if current is not None:
        kc, kcs, vc, vcs = current
        slc = kcs.shape[-1]
        if (kc.shape != (b, 1, h * d) or vc.shape != kc.shape or kcs.shape != (b, 1, slc)
                or vcs.shape != kcs.shape or slc < h or kc.dtype != torch.int8
                or vc.dtype != torch.int8 or kcs.dtype != torch.bfloat16
                or vcs.dtype != torch.bfloat16):
            raise ValueError(f"bad current row {kc.shape} {kcs.shape} for q {q8.shape}")
        if write and slc != sl:
            raise ValueError(f"the written scale row has {slc} entries, the cache's {sl}")
        cur = [kc.data_ptr(), kcs.data_ptr(), vc.data_ptr(), vcs.data_ptr(), slc, int(write)]
    else:
        cur = [None] * 4 + [0, 0]
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_int8_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    rc = fn(q8.data_ptr(), qs.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(),
            vs.data_ptr(), *[m.data_ptr() for m in masks], *pre, *cur, out.data_ptr(),
            layer_idx, b, s_len, h, d, sl, kv_stride, plan.splits, plan.per * bs, bs, vec, scale,
            torch.cuda.current_stream(q8.device).cuda_stream)
    return rc, out


def _cache_checks(q8, k8, ks, v8, vs):
    b, h, d = q8.shape
    if k8.shape[1] != b or k8.shape[-1] != h * d or v8.shape != k8.shape \
            or vs.shape != ks.shape or ks.shape[:3] != k8.shape[:3]:
        raise ValueError(f"cache shapes {k8.shape} {ks.shape} do not fit q {q8.shape}")
    if not all(t.is_contiguous() for t in (k8, ks, v8, vs)):
        raise ValueError("K2 takes a contiguous cache")


def flash_decode_int8_kernel(q8, qs, k8, ks, v8, vs, masks, layer_idx: int,
                             scale: float, bs: int, shared=None, p0: int = 0):
    """K2 (and K2' with per-lane intervals) on the card; same signature and
    result as the plain version."""
    _cache_checks(q8, k8, ks, v8, vs)
    n_layers, _, s_len, hd = k8.shape
    rc, out = _launch(q8, qs, k8, ks, v8, vs, masks, layer_idx, scale, bs, n_layers, s_len,
                      hd, ks.shape[-1], shared=shared, p0=p0)
    flash_decode_int8_kernel.launches += 1
    _build.check(rc, "flash_decode_int8_launch")
    return out


flash_decode_int8_kernel.launches = 0


def flash_decode_int8_current_kernel(q8, qs, k8, ks, v8, vs, masks, layer_idx: int,
                                     scale: float, bs: int, shared=None, p0: int = 0,
                                     current=None, write_cache: bool = False):
    """K2'' on the card: the plain version's signature with the step's own
    row ``current``, written at slot b1 + 1 of each lane with
    ``write_cache``. The caller keeps that slot below S."""
    if current is None:
        raise ValueError("K2'' takes the current row")
    _cache_checks(q8, k8, ks, v8, vs)
    n_layers, _, s_len, hd = k8.shape
    rc, out = _launch(q8, qs, k8, ks, v8, vs, masks, layer_idx, scale, bs, n_layers, s_len,
                      hd, ks.shape[-1], shared=shared, p0=p0, current=current,
                      write=write_cache)
    flash_decode_int8_current_kernel.launches += 1
    _build.check(rc, "flash_decode_int8_launch")
    return out


flash_decode_int8_current_kernel.launches = 0


def flash_decode_int8_fused_plain(q8, qs, kv8, kvs, masks, layer_idx: int, scale: float,
                                  bs: int):
    """Plain version of T1: K2's plain version over the two halves of the
    interleaved buffers, as views. kv8 (L,B,S,2*H*D) int8 with k in the first
    half of each row; kvs (L,B,S,2*H) bf16 with the k scales first."""
    h, hd = q8.shape[1], q8.shape[1] * q8.shape[2]
    return flash_decode_int8_plain(q8, qs, kv8[..., :hd], kvs[..., :h], kv8[..., hd:],
                                   kvs[..., h:], masks, layer_idx, scale, bs)


def flash_decode_int8_fused_kernel(q8, qs, kv8, kvs, masks, layer_idx: int, scale: float,
                                   bs: int):
    """T1 on the card: K2's lane kernel reading k at offset 0 and v at offset
    H*D of each 2*H*D-byte row, and the scales likewise. Bitwise K2 on the
    same data."""
    b, h, d = q8.shape
    n_layers, _, s_len, width = kv8.shape
    if kv8.shape[1] != b or width != 2 * h * d or kvs.shape != (n_layers, b, s_len, 2 * h):
        raise ValueError(f"fused cache shapes {kv8.shape} {kvs.shape} do not fit q {q8.shape}")
    if not (kv8.is_contiguous() and kvs.is_contiguous()):
        raise ValueError("T1 takes contiguous fused buffers")
    hd = h * d
    rc, out = _launch(q8, qs, kv8, kvs, kv8[..., hd:], kvs[..., h:], masks, layer_idx, scale,
                      bs, n_layers, s_len, 2 * hd, 2 * h)
    flash_decode_int8_fused_kernel.launches += 1
    _build.check(rc, "flash_decode_int8_launch")
    return out


flash_decode_int8_fused_kernel.launches = 0


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


def _resolve(q, s_len, scale, bs):
    d = q.shape[2]
    scale = float(scale if scale is not None else d ** -0.5)
    return scale, default_bs(s_len) if bs is None else resolve_bs(s_len, bs)


def flash_decode_int8(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                      v8: torch.Tensor, vs: torch.Tensor, lengths: torch.Tensor,
                      prompt_pad=None, step=None, layer_idx: int = 0,
                      scale: Optional[float] = None, bs: Optional[int] = None,
                      shared=None, p0=None, gen_intervals=None, current=None,
                      write_cache: bool = False):
    """Single-token attention over layer ``layer_idx`` of the stacked int8
    cache. q (B,H,D) float; k8/v8 (L,B,S,H*D) int8; ks/vs (L,B,S,SL) bf16
    with SL >= H; lengths (B,) prompt-region lengths; (prompt_pad, step) the
    static-slot mask or gen_intervals (a1, b1, a2, b2) per lane; shared =
    (k0, ks0, v0, vs0) one layer's int8 prefix with p0 live rows. Returns
    (B,H,D) in q.dtype.

    current = (kc8, kcs, vc8, vcs): the step's own K/V row, (B,1,H*D) int8
    and (B,1,SL) bf16, always attended; the caller's mask ends one slot
    before it (step - 1). With ``write_cache`` (the static-slot mask only)
    the row is written in place at slot prompt_pad + step + 1 of layer
    ``layer_idx`` in all four buffers, and the result is (o, (k8, ks, v8,
    vs)), the same cache objects. A slot at or past S raises."""
    s_len = k8.shape[2]
    scale, bs = _resolve(q, s_len, scale, bs)
    if write_cache:
        if current is None or gen_intervals is not None:
            raise ValueError("write_cache takes the current row and the static-slot mask")
        if int(prompt_pad) + int(step) + 1 >= s_len:
            raise ValueError(f"write slot {int(prompt_pad) + int(step) + 1} is past the "
                             f"cache's {s_len} slots")
    q8, qs = quantize_q(q)
    masks = slot_masks(lengths, prompt_pad, step, gen_intervals)
    kw = dict(shared=shared, p0=0 if p0 is None else int(p0))
    if current is not None:
        kw.update(current=current, write_cache=write_cache)
        fn = flash_decode_int8_current_kernel if q.is_cuda else flash_decode_int8_plain
    else:
        fn = flash_decode_int8_kernel if q.is_cuda else flash_decode_int8_plain
    out = fn(q8, qs, k8, ks, v8, vs, masks, layer_idx, scale, bs, **kw).to(q.dtype)
    return (out, (k8, ks, v8, vs)) if write_cache else out


def flash_decode_int8_fused(q: torch.Tensor, kv8: torch.Tensor, kvs: torch.Tensor,
                            lengths: torch.Tensor, prompt_pad: int, step: int,
                            layer_idx: int = 0, scale: Optional[float] = None,
                            bs: Optional[int] = None) -> torch.Tensor:
    """T1: ``flash_decode_int8`` with the static-slot mask and no prefix over
    one interleaved buffer: kv8 (L,B,S,2*H*D) int8, k in the first half of
    each row; kvs (L,B,S,2*H) bf16, the k scales first. Returns (B,H,D) in
    q.dtype."""
    scale, bs = _resolve(q, kv8.shape[2], scale, bs)
    q8, qs = quantize_q(q)
    masks = slot_masks(lengths, prompt_pad, step)
    fn = flash_decode_int8_fused_kernel if q.is_cuda else flash_decode_int8_fused_plain
    return fn(q8, qs, kv8, kvs, masks, layer_idx, scale, bs).to(q.dtype)
