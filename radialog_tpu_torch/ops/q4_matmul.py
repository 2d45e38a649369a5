"""W4A8 matmul: per-row int8 activations x nibble-packed int4 weights with
group-wise scales (and offsets on the asymmetric grid).

Port of radialog_tpu/ops/q4_matmul.py, the opt-in 4-bit weight mode of the
serving layers. The port keeps a weight as ``PackedQ4.w`` (N, K/2) bytes,
row-major: byte j of row n holds code q[2j] in its low nibble and q[2j+1]
in its high nibble (two's complement, [-8, 7]), with ``gscale`` / ``goff``
(G, N) f32. The TPU's (kt, nt, bk/2, bn) tiles, its N padding and the
even/odd split of the activations are gone; K is not padded in memory.

The group geometry is part of the numbers and is the JAX package's: K is
padded with zero rows to a multiple of ``pick_bk(K)`` before the grids are
fitted, and the group shrinks to that block when it does not divide it. So
a last group may be fitted on real rows and zeros (K = 11008: 22 groups of
512, the last half zeros), and G counts the padded groups.

  acc = sum over groups g, in K order, of
          f32(x8_g @ q_g) * gscale[g]  (+ f32(rowsum(x8_g)) * goff[g])
  y   = acc * x_scale[:, None] (+ b)

``q4_matmul_acc`` computes ``acc``: on a CUDA tensor it launches the
hand-written kernel K4 (csrc/q4_matmul.cu, replacing the Pallas kernel of
``_make_kernel``: T3's TMA ring and register-operand int8 wgmma, with the
group's rescale in registers) and on a CPU tensor it runs the plain PyTorch
version ``q4_matmul_acc_plain``. Each group's integer sums are exact and
both add the groups in the same order with single rounded f32 operations,
so the two agree bit for bit, also where the kernel splits K across blocks:
the last block of a tile to arrive adds the other splits' group terms in
group order. ``_plan`` chooses the launch. There is no fallback from one to
the other.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from .q8_matmul import MIN_SPLIT_KTILES, SM_COUNT, quantize_act

GROUP = 512        # K rows per scale group
KERNEL_BK = 128    # one activation box of the kernel: a group must be a multiple of it
MAX_GROUP = 131040  # the kernel sums 16 q x in int32 over a group: group * 2^14 < 2^31
TICKETS = 1024     # output tiles a split launch may have: one int32 ticket each
SCALE_SLOTS = 3    # groups whose scales a block holds at once (csrc/q4_matmul.cu)
# the W4A8 ring of K4 and T2/T3 (csrc/w4_tma.cuh)
KTILE = 256                  # K values a stage holds: 128 packed bytes a weight row
SLOTS_PER_SM = 2             # blocks an SM holds: ~100 KB of shared memory each
SMEM_PER_SM = 228 * 1024     # H100: shared memory an SM gives its blocks
WNS = (8, 16, 32, 64)        # wgmma N: the activation rows a block takes
# the ring's stages by weight rows a block and wn (w4_tma.cuh stages_of); K4
# takes 128 rows only at wn <= 32
STAGES = {128: {8: 6, 16: 5, 32: 4, 64: 3}, 64: {8: 8, 16: 8, 32: 6, 64: 4}}


def pick_bk(k: int, cap: int = 2048) -> int:
    """The JAX package's K block (a multiple of 128): K is padded to a
    multiple of it before the groups are cut."""
    if k <= cap:
        return k if k % 128 == 0 else ((k + 127) // 128) * 128
    return cap if k % cap == 0 else 1024


@dataclasses.dataclass
class PackedQ4:
    """A nibble-packed int4 serving weight: w (N, K/2) int8 bytes, gscale
    (G, N) f32, goff (G, N) f32 or None (symmetric grid), the group size
    and an optional bias (N,)."""

    w: torch.Tensor
    gscale: torch.Tensor
    group: int = GROUP
    goff: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.w.shape[0]

    @property
    def k(self) -> int:
        return 2 * self.w.shape[1]

    def to(self, device) -> "PackedQ4":
        return PackedQ4(self.w.to(device), self.gscale.to(device), self.group,
                        None if self.goff is None else self.goff.to(device),
                        None if self.b is None else self.b.to(device))


def _fit_asym_grid(grouped: np.ndarray, search: int):
    """MSE-optimal clipped asymmetric 4-bit grid per (group, out-channel).

    grouped (G, group, N) f32. The grid is dequant = s*q + m with q in
    [-8, 7]. Candidates shrink [min, max] about its midpoint by ratios r in
    [0.68, 1]; per (g, n) the r with the smallest quantization MSE wins.
    Returns (gscale (G,N), goff (G,N), codes (G, group, N) int8). The same
    numpy operations in the same order as the JAX package's fit, so the
    result is bitwise the same."""
    lo = grouped.min(axis=1)
    hi = grouped.max(axis=1)
    mid = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    best_mse = best_s = best_m = None
    for r in np.linspace(0.68, 1.0, search, dtype=np.float32):
        s = np.maximum(2.0 * r * half / 15.0, 1e-8).astype(np.float32)
        m = (mid - r * half + 8.0 * s).astype(np.float32)   # q = -8 at the clipped low end
        q = np.clip(np.round((grouped - m[:, None, :]) / s[:, None, :]), -8, 7)
        err = s[:, None, :] * q + m[:, None, :] - grouped
        mse = np.mean(err * err, axis=1)
        if best_mse is None:
            best_mse, best_s, best_m = mse, s, m
        else:
            better = mse < best_mse
            best_s = np.where(better, s, best_s)
            best_m = np.where(better, m, best_m)
            best_mse = np.minimum(mse, best_mse)
    w_q = np.clip(np.round((grouped - best_m[:, None, :]) / best_s[:, None, :]),
                  -8, 7).astype(np.int8)
    return best_s, best_m, w_q


def pack_q4(w: np.ndarray, group: int = GROUP, b=None, mode: str = "asym",
            search: int = 9) -> PackedQ4:
    """(K, N) float (numpy, host) -> PackedQ4 on the CPU. K must be even.

    mode="asym": the clipped asymmetric grid of ``_fit_asym_grid`` (goff
    set). mode="sym": symmetric absmax, codes in [-7, 7], goff None."""
    w = np.asarray(w, np.float32)
    k, n = w.shape
    if k % 2:
        raise ValueError(f"pack_q4 packs two K rows per byte: K={k} is odd")
    bk = pick_bk(k)
    if bk % group:
        group = bk
    kpad = (-k) % bk
    if kpad:
        w = np.pad(w, ((0, kpad), (0, 0)))
    grouped = w.reshape((k + kpad) // group, group, n)
    if mode == "asym":
        gscale, goff, w_q = _fit_asym_grid(grouped, search)
        gscale, goff = gscale.astype(np.float32), goff.astype(np.float32)
    elif mode == "sym":
        gscale = np.maximum(np.abs(grouped).max(axis=1) / 7.0, 1e-8).astype(np.float32)
        goff = None
        w_q = np.clip(np.round(grouped / gscale[:, None, :]), -7, 7).astype(np.int8)
    else:
        raise ValueError(f"mode must be 'asym' or 'sym', got {mode!r}")
    w_q = w_q.reshape(k + kpad, n)[:k]
    packed = ((w_q[1::2].astype(np.uint8) << 4) | (w_q[0::2].astype(np.uint8) & 0xF)
              ).astype(np.int8)                                  # (K/2, N)
    return PackedQ4(torch.from_numpy(np.ascontiguousarray(packed.T)),
                    torch.from_numpy(gscale), group,
                    None if goff is None else torch.from_numpy(goff),
                    None if b is None else torch.as_tensor(np.asarray(b)))


def unpack_q4(w: torch.Tensor) -> torch.Tensor:
    """(N, K/2) packed bytes -> (N, K) int8 codes in [-8, 7]."""
    lo = ((w & 15) ^ 8) - 8
    hi = w >> 4                     # arithmetic shift of int8: the signed high nibble
    return torch.stack([lo, hi], dim=-1).reshape(w.shape[0], -1)


def q4_matmul_acc_plain(x8: torch.Tensor, w: torch.Tensor, gscale: torch.Tensor,
                        goff: Optional[torch.Tensor], group: int) -> torch.Tensor:
    """Plain version of K4: (M,K) int8 x packed (N,K/2) -> (M,N) f32, the
    groups added in K order as the kernel adds them. Each group's integer
    dot is exact in float64 (below group * 127 * 8 < 2^24, so its cast to
    f32 is exact too)."""
    m, k = x8.shape
    acc = torch.zeros((m, w.shape[0]), dtype=torch.float32, device=x8.device)
    for g in range(-(-k // group)):
        cols = slice(g * group, min((g + 1) * group, k))
        xg = x8[:, cols]
        wg = unpack_q4(w[:, cols.start // 2:cols.stop // 2])
        upd = torch.matmul(xg.double(), wg.double().T).float() * gscale[g][None, :]
        if goff is not None:
            rowsum = xg.sum(dim=1, dtype=torch.int32).float()
            upd = upd + rowsum[:, None] * goff[g][None, :]
        acc = acc + upd
    return acc


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of K4: ``wn`` activation rows (wgmma's N) by ``rows`` weight
    rows (64 per consumer warpgroup) a block, a ring of ``stages``, K cut
    into ``splits`` ranges of ``per`` stages of KTILE values, each starting
    on a group boundary; ``asym``: the asymmetric grid, whose block has a
    row-sum warp."""

    wn: int
    rows: int
    stages: int
    splits: int
    per: int
    asym: bool

    def tiles(self, m: int, n: int) -> int:
        return -(-m // self.wn) * -(-n // self.rows)

    def smem(self) -> int:
        """Shared memory a block takes (csrc/q4_matmul.cu smem_of): the ring,
        its mbarriers, alignment, the row-sum barriers and, on the
        asymmetric grid, the row sums; SCALE_SLOTS groups' scales and offsets."""
        ring = self.stages * 128 * (self.rows + 2 * self.wn) + 16 * self.stages + 1024
        return (ring + self.stages * (8 + (8 * self.wn if self.asym else 0))
                + SCALE_SLOTS * 2 * self.rows * 4)


def group_stages(group: int) -> int:
    """The fewest whole stages that end on a group boundary: a K split's unit."""
    return math.lcm(group, KTILE) // KTILE


def _plan(m: int, n: int, k: int, group: int, asym: bool, rows: Optional[int] = None) -> Plan:
    """The launch for (M, K) activations x (N, K/2) packed weights in groups
    of ``group``, T3's plan (``ops/w4_colscale._plan``) with K4's limits. wn
    is the least of 8, 16, 32, 64 that holds the rows (64 above 64 rows,
    tiled over the grid). 64 weight rows a block, unless those tiles would
    not fit the card's 2 x 132 slots at once: then 128 (two consumer
    warpgroups share each stage of activations), but never at wn = 64,
    where two warpgroups' registers would not leave two blocks an SM;
    ``rows`` forces either. The ring is as deep as ~100 KB allows. K is
    split (K1's rule) only where the output tiles leave the slots half
    empty, into as many ranges as fit the slots, each at least 4 stages
    deep and a whole number of ``group_stages`` long, so that every split
    starts on a group boundary: down at M = 16 (43 stages, groups of 2)
    takes 4 splits of 12, not T3's 11."""
    wn = next(w for w in WNS if min(m, WNS[-1]) <= w)
    slots = SLOTS_PER_SM * SM_COUNT
    if rows is None:
        rows = 64 if wn == 64 or -(-m // wn) * -(-n // 64) <= slots else 128
    tiles = -(-m // wn) * -(-n // rows)
    ktiles = -(-k // KTILE)
    unit = group_stages(group)
    splits = 1
    if 2 * tiles <= slots:
        splits = max(1, min(slots // tiles, ktiles // MIN_SPLIT_KTILES))
    per = -(-(-(-ktiles // splits)) // unit) * unit
    return Plan(wn, rows, STAGES[rows][wn], -(-ktiles // per), per, asym)


_split_buffers: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, numel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split launches' workspace (f32, at least ``numel``) and tickets
    (TICKETS int32, zero between calls: the last block of a tile resets
    its own) on ``device``, allocated once per device and grown, never
    zeroed per call. Calls on one device share them, so they run on one
    stream, in order."""
    ws, tickets = _split_buffers.get(device, (None, None))
    if tickets is None:
        tickets = torch.zeros(TICKETS, dtype=torch.int32, device=device)
    if ws is None or ws.numel() < numel:
        ws = torch.empty(max(numel, 1 << 20), dtype=torch.float32, device=device)
    _split_buffers[device] = (ws, tickets)
    return ws, tickets


def _launch(x8: torch.Tensor, w: torch.Tensor, gscale: torch.Tensor,
            goff: Optional[torch.Tensor], group: int, plan: Plan) -> torch.Tensor:
    """Launch K4 with ``plan``, counting the launch on ``q4_matmul_acc``;
    raise on a plan the kernel does not take or a failed launch."""
    m, k = x8.shape
    n = w.shape[0]
    splits = -(-(-(-k // KTILE)) // plan.per)
    if plan.asym != (goff is not None):
        raise ValueError(f"K4: a plan for the {'a' if plan.asym else ''}symmetric grid with "
                         f"goff {'absent' if goff is None else 'present'}")
    if splits > 1 and (plan.per % group_stages(group) or plan.tiles(m, n) > TICKETS):
        raise ValueError(f"K4 splits K on group boundaries over at most {TICKETS} tiles: "
                         f"{plan} at M={m}, N={n}, group={group}")
    ws = tickets = None
    if splits > 1:
        ws, tickets = _workspace(x8.device,
                                 plan.tiles(m, n) * -(-k // group) * plan.wn * plan.rows)
    out = torch.empty((m, n), dtype=torch.float32, device=x8.device)
    fn = _build.load("q4_matmul").q4_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x8.data_ptr(), w.data_ptr(), gscale.data_ptr(),
            None if goff is None else goff.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), None if tickets is None else tickets.data_ptr(),
            m, n, k, group, plan.wn, plan.rows, plan.stages, plan.per,
            torch.cuda.current_stream(x8.device).cuda_stream)
    q4_matmul_acc.launches += 1
    _build.check(rc, "q4_gemm_launch")
    return out


def q4_matmul_acc(x8: torch.Tensor, w: torch.Tensor, gscale: torch.Tensor,
                  goff: Optional[torch.Tensor], group: int) -> torch.Tensor:
    """(M,K) int8 x packed (N,K/2) int4 -> (M,N) f32 group-rescaled sums.
    Kernel K4 on a CUDA tensor, the plain version on a CPU tensor."""
    if not x8.is_cuda:
        return q4_matmul_acc_plain(x8, w, gscale, goff, group)
    m, k = x8.shape
    n, k2 = w.shape
    groups = -(-k // group)
    if k != 2 * k2 or x8.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"q4 kernel takes int8 (M,K) x packed (N,K/2): {x8.shape} {w.shape}")
    if k % 32 or group % KERNEL_BK or group > MAX_GROUP:
        raise ValueError(f"q4 kernel needs K % 32 == 0 and group % {KERNEL_BK} == 0, "
                         f"group <= {MAX_GROUP}, got K={k}, group={group}")
    scales = [gscale] if goff is None else [gscale, goff]
    for s in scales:
        if s.dtype != torch.float32 or s.shape[0] < groups or s.shape[1:] != (n,):
            raise ValueError(f"q4 kernel takes (G >= {groups}, {n}) f32 scales, got {s.shape}")
    for t in (x8, w, *scales):
        if not (t.is_cuda and t.is_contiguous() and t.device == x8.device):
            raise ValueError("q4 kernel takes contiguous CUDA operands on one device")
    for t in (x8, w):
        if t.data_ptr() % 16:
            raise ValueError("q4 kernel takes 16-byte aligned activations and weights")
    return _launch(x8, w, gscale, goff, group, _plan(m, n, k, group, goff is not None))


q4_matmul_acc.launches = 0


def _matmul(acc_fn, x: torch.Tensor, packed: PackedQ4, out_dtype) -> torch.Tensor:
    x8, xs = quantize_act(x.reshape(-1, x.shape[-1]))
    y = acc_fn(x8, packed.w, packed.gscale, packed.goff, packed.group) * xs[:, None]
    if packed.b is not None:
        y = y + packed.b.float()
    return y.to(out_dtype).reshape(*x.shape[:-1], packed.n)


def q4_matmul(x: torch.Tensor, packed: PackedQ4, out_dtype=torch.float32) -> torch.Tensor:
    """(..., K) float x PackedQ4 -> (..., N) out_dtype."""
    return _matmul(q4_matmul_acc, x, packed, out_dtype)


def q4_matmul_plain(x: torch.Tensor, packed: PackedQ4, out_dtype=torch.float32) -> torch.Tensor:
    """``q4_matmul`` through the plain version on any device."""
    return _matmul(q4_matmul_acc_plain, x, packed, out_dtype)
