"""W8A8 matmul: per-row int8 activations x per-channel int8 weights.

Port of radialog_tpu/ops/q8_matmul.py. The port keeps weights as
``PackedQ8.w`` (N, K) int8 row-major with per-output-channel f32 scales; the
TPU's (kt, nt, bk, bn) tiles and N/K padding are gone.

  y = (acc * x_scale[:, None]) * w_scale[None, :] (+ b),  acc = x8 @ w8^T

``q8_matmul_int32`` computes the exact int32 accumulator: on a CUDA tensor
it launches the hand-written kernel K1 (csrc/q8_matmul.cu, replacing the
Pallas ``_kernel`` of the JAX package) and on a CPU tensor it runs the plain
PyTorch version ``q8_matmul_int32_plain``. There is no fallback from one to
the other. ``_plan`` chooses K1's launch: TMA + wgmma on 128 x 256 (or 128 x
128) tiles for prefill and admission rows, the same kernel with the operands
swapped for decode rows (M <= 64), and a split of K when the tiles cannot
fill the card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

SM_COUNT = 132        # H100 SXM
DECODE_MAX_M = 64     # rows up to this take the swapped route: wgmma's N is the rows
MIN_SPLIT_KTILES = 4  # a split of K keeps at least this many K tiles
KTILE = 128           # K bytes a stage holds: one 128-byte swizzle row


@dataclasses.dataclass(frozen=True)
class Plan:
    """K1's launch. ``route``: "wgmma" (prefill and admission rows, two
    consumer warpgroups on a 128 x ``wn`` tile) or "swap" (decode rows: C^T
    = W . X^T, 64 weight rows x ``wn`` padded activation rows). ``tile`` is the
    output tile (rows of M, columns of N); K is cut into ``splits`` ranges
    of ``per`` tiles of KTILE bytes, whose int32 sums are added with atomics
    when there is more than one."""

    route: str
    tile: Tuple[int, int]
    wn: int
    stages: int
    splits: int
    per: int

    def blocks(self, m: int, n: int) -> int:
        return -(-m // self.tile[0]) * -(-n // self.tile[1]) * self.splits


def _split(tiles: int, ktiles: int, slots: int) -> Tuple[int, int]:
    """(splits, K tiles per split): split K only where the output tiles
    leave the card's ``slots`` (blocks that run at once) half empty, into as
    many ranges as fit the slots, each at least MIN_SPLIT_KTILES deep."""
    splits = 1
    if 2 * tiles <= slots:
        splits = max(1, min(slots // tiles, ktiles // MIN_SPLIT_KTILES))
    per = -(-ktiles // splits)
    return -(-ktiles // per), per


def _plan(m: int, n: int, k: int) -> Plan:
    """K1's launch plan for (M,K) x (N,K). Decode rows (M <= 64) swap the
    operands and pad M to wgmma's N (8, 16, 32 or 64), with a ring of 8
    stages (6 at 64) and two blocks an SM. More rows take 128 x 256 tiles
    and 4 stages, one block an SM; where those tiles would leave half the
    card empty and split K (an admission's 256 rows at N = 4096), 128 x 128
    tiles and 6 stages, which split K less and measured faster there."""
    if m <= DECODE_MAX_M:
        wn = next(w for w in (8, 16, 32, 64) if m <= w)
        route, tile, stages, slots = "swap", (wn, 64), (6 if wn == 64 else 8), 2 * SM_COUNT
    else:
        wide = 2 * -(-m // 128) * -(-n // 256) > SM_COUNT
        wn, stages = (256, 4) if wide else (128, 6)
        route, tile, slots = "wgmma", (128, wn), SM_COUNT
    tiles = -(-m // tile[0]) * -(-n // tile[1])
    splits, per = _split(tiles, -(-k // KTILE), slots)
    return Plan(route, tile, wn, stages, splits, per)


@dataclasses.dataclass
class PackedQ8:
    """An int8 serving weight: w (N, K) int8, scale (N,) f32, optional bias (N,)."""

    w: torch.Tensor
    scale: torch.Tensor
    b: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.w.shape[0]

    @property
    def k(self) -> int:
        return self.w.shape[1]

    def to(self, device) -> "PackedQ8":
        return PackedQ8(self.w.to(device), self.scale.to(device),
                        None if self.b is None else self.b.to(device))


@functools.lru_cache(maxsize=None)
def _f32_127(device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):   # usable in autograd whoever made it first
        return torch.full((), 127.0, dtype=torch.float32, device=device)


def div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` of an f32 tensor as an IEEE division, as numpy and JAX
    divide. PyTorch's CUDA division by a Python scalar multiplies by the
    scalar's reciprocal, which rounds differently; the divisor is a 0-dim
    tensor kept on each device, so no call copies it from the host."""
    return x / _f32_127(x.device)


def pack_q8(w, b=None) -> PackedQ8:
    """(K, N) float -> PackedQ8. Symmetric per-output-channel scales; the
    same rounding as the JAX package's ``pack_q8``. A numpy array is packed
    on the host; a tensor on its own device, in f32 with the same
    operations (max, an IEEE division, round half to even), so the bytes
    are the host's."""
    if isinstance(w, torch.Tensor):
        wf = w.float()
        scale = torch.clamp(div127(wf.abs().amax(dim=0)), min=1e-8)
        w_q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127).to(torch.int8)
        return PackedQ8(w_q.T.contiguous(), scale,
                        None if b is None else torch.as_tensor(b, device=w.device))
    w = np.asarray(w, np.float32)
    scale = np.maximum(np.abs(w).max(axis=0) / 127.0, 1e-8).astype(np.float32)
    w_q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return PackedQ8(torch.from_numpy(np.ascontiguousarray(w_q.T)),
                    torch.from_numpy(scale),
                    None if b is None else torch.as_tensor(np.asarray(b)))


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (x8 (M,K) int8, x_scale (M,) f32). Round half
    to even on x / (max|x| / 127) in f32, bitwise equal to the JAX version."""
    xf = x.float()
    xs = div127(torch.clamp(xf.abs().amax(dim=-1), min=1e-8))
    x8 = torch.clamp(torch.round(xf / xs[..., None]), -127, 127).to(torch.int8)
    return x8, xs


def q8_matmul_int32_plain(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: (M,K) int8 x (N,K) int8 -> (M,N) int32. Exact in
    float64: every partial sum is an integer below K * 127^2 < 2^53 (and
    float64 matmuls run on the card, integer ones do not)."""
    return torch.matmul(x8.double(), w8.double().T).to(torch.int32)


def q8_matmul_int32(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(M,K) int8 x (N,K) int8 -> (M,N) int32. Kernel K1 on a CUDA tensor,
    the plain version on a CPU tensor."""
    if not x8.is_cuda:
        return q8_matmul_int32_plain(x8, w8)
    m, k = x8.shape
    n, k2 = w8.shape
    if k != k2 or x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise ValueError(f"q8 kernel takes int8 (M,K) x (N,K): {x8.shape} {w8.shape}")
    if k % 16:
        raise ValueError(f"q8 kernel needs K % 16 == 0, got K={k}")
    if not (x8.is_contiguous() and w8.is_contiguous()) or w8.device != x8.device:
        raise ValueError("q8 kernel takes contiguous operands on one device")
    if x8.data_ptr() % 16 or w8.data_ptr() % 16:
        raise ValueError("q8 kernel takes operands at 16-byte aligned addresses (TMA)")
    plan = _plan(m, n, k)
    out = (torch.zeros if plan.splits > 1 else torch.empty)((m, n), dtype=torch.int32,
                                                            device=x8.device)
    lib = _build.load("q8_matmul")
    fn = lib.q8_gemm_s8s8s32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x8.data_ptr(), w8.data_ptr(), out.data_ptr(), m, n, k, int(plan.route == "swap"),
            plan.wn, plan.stages, plan.per, torch.cuda.current_stream(x8.device).cuda_stream)
    q8_matmul_int32.launches += 1
    _build.check(rc, "q8_gemm_s8s8s32")
    return out


q8_matmul_int32.launches = 0


def _finish(acc: torch.Tensor, xs: torch.Tensor, packed: PackedQ8, lead,
            out_dtype) -> torch.Tensor:
    y = acc.float() * xs[:, None] * packed.scale[None, :].float()
    if packed.b is not None:
        y = y + packed.b.float()
    return y.to(out_dtype).reshape(*lead, packed.n)


def q8_matmul(x: torch.Tensor, packed: PackedQ8, out_dtype=torch.float32) -> torch.Tensor:
    """(..., K) float x PackedQ8 -> (..., N) out_dtype."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    x8, xs = quantize_act(x.reshape(-1, k))
    acc = q8_matmul_int32(x8, packed.w)
    return _finish(acc, xs, packed, lead, out_dtype)
