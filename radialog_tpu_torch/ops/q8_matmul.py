"""W8A8 matmul: per-row int8 activations x per-channel int8 weights.

Port of radialog_tpu/ops/q8_matmul.py. The port keeps weights as
``PackedQ8.w`` (N, K) int8 row-major with per-output-channel f32 scales; the
TPU's (kt, nt, bk, bn) tiles and N/K padding are gone.

  y = (acc * x_scale[:, None]) * w_scale[None, :] (+ b),  acc = x8 @ w8^T

``q8_matmul_int32`` computes the exact int32 accumulator: on a CUDA tensor
it launches the hand-written kernel K1 (csrc/q8_matmul.cu, replacing the
Pallas ``_kernel`` of the JAX package) and on a CPU tensor it runs the plain
PyTorch version ``q8_matmul_int32_plain``. There is no fallback from one to
the other.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

SM_COUNT = 132  # H100 SXM: split K when the output has fewer tiles than 2x this
TILE = 64       # the kernel's output tile (64 x 64)


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


def pack_q8(w: np.ndarray, b=None) -> PackedQ8:
    """(K, N) float (numpy, host) -> PackedQ8. Symmetric per-output-channel
    scales; the same rounding as the JAX package's ``pack_q8``."""
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
    xs = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    x8 = torch.clamp(torch.round(xf / xs[..., None]), -127, 127).to(torch.int8)
    return x8, xs


def q8_matmul_int32_plain(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: (M,K) int8 x (N,K) int8 -> (M,N) int32. Exact in
    float64: every partial sum is an integer below K * 127^2 < 2^53 (and
    float64 matmuls run on the card, integer ones do not)."""
    return torch.matmul(x8.double(), w8.double().T).to(torch.int32)


def _splits(m: int, n: int, k: int) -> int:
    tiles = -(-m // TILE) * -(-n // TILE)
    ktiles = -(-k // TILE)
    if tiles >= 2 * SM_COUNT:
        return 1
    # at least 8 K tiles (512 deep) per split
    return max(1, min(-(-2 * SM_COUNT // tiles), ktiles // 8))


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
    splits = _splits(m, n, k)
    out = (torch.zeros if splits > 1 else torch.empty)((m, n), dtype=torch.int32,
                                                       device=x8.device)
    lib = _build.load("q8_matmul")
    fn = lib.q8_gemm_s8s8s32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x8.data_ptr(), w8.data_ptr(), out.data_ptr(), m, n, k, splits,
            torch.cuda.current_stream(x8.device).cuda_stream)
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
