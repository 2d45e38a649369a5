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
``_make_kernel``) and on a CPU tensor it runs the plain PyTorch version
``q4_matmul_acc_plain``. Each group's integer sums are exact and both add
the groups in the same order with single rounded f32 operations, so the two
agree bit for bit. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import _build
from .q8_matmul import quantize_act

GROUP = 512        # K rows per scale group
KERNEL_BK = 128    # the kernel's K tile: a group must be a multiple of it


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
    if k % 32 or group % KERNEL_BK:
        raise ValueError(f"q4 kernel needs K % 32 == 0 and group % {KERNEL_BK} == 0, "
                         f"got K={k}, group={group}")
    scales = [gscale] if goff is None else [gscale, goff]
    for s in scales:
        if s.dtype != torch.float32 or s.shape[0] < groups or s.shape[1:] != (n,):
            raise ValueError(f"q4 kernel takes (G >= {groups}, {n}) f32 scales, got {s.shape}")
    for t in (x8, w, *scales):
        if not (t.is_cuda and t.is_contiguous() and t.device == x8.device):
            raise ValueError("q4 kernel takes contiguous CUDA operands on one device")
    out = torch.empty((m, n), dtype=torch.float32, device=x8.device)
    lib = _build.load("q4_matmul")
    fn = lib.q4_gemm_s8s4f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x8.data_ptr(), w.data_ptr(), gscale.data_ptr(),
            None if goff is None else goff.data_ptr(), out.data_ptr(), m, n, k, group,
            torch.cuda.current_stream(x8.device).cuda_stream)
    q4_matmul_acc.launches += 1
    _build.check(rc, "q4_gemm_s8s4f32")
    return out


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
