"""Per-column W4A8: int8 activations x int4 weights with one scale per
output column, the two prototypes of tools/microbench_w4.py (T2 and T3).

Port of that tool's ``pack_q4``, ``q4_matmul`` (T2, the Pallas
``_w4_kernel``: the activations split into their even and odd K values) and
``q4p_matmul`` (T3, ``_w4p_kernel``: the whole activation row). Off the
serving path: the serving layers' 4-bit mode is the grouped K4
(ops/q4_matmul.py); these exist for their tool,
tools/microbench_w4_torch.py.

The codes are the tool's, bit for bit: scale = max(max|w| / 7, 1e-8) per
column in f32, q = clip(round(w / scale), -7, 7). The layout is the port's
own: ``PackedQ4C.w`` (N, K/2) bytes, byte j of row n holds q[2j] in its low
nibble and q[2j+1] in its high nibble. The TPU's (kt, nt, bk/2, bn) tiles
and its K and N padding are gone.

  acc = x8 @ q (exact int32);  y = bf16(f32(acc) * x_scale[:, None] * scale)

``w4_int32_split`` (T2) and ``w4_int32`` (T3) compute ``acc``: on a CUDA
tensor each launches its kernel of csrc/w4_colscale.cu, on a CPU tensor
both run the one plain version ``w4_int32_plain``. Integer sums are exact,
so kernel and plain version agree bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from . import _build
from .q4_matmul import unpack_q4
from .q8_matmul import quantize_act


@dataclasses.dataclass
class PackedQ4C:
    """A per-column int4 weight: w (N, K/2) int8 nibble pairs, scale (N,) f32."""

    w: torch.Tensor
    scale: torch.Tensor

    @property
    def n(self) -> int:
        return self.w.shape[0]

    @property
    def k(self) -> int:
        return 2 * self.w.shape[1]

    def to(self, device) -> "PackedQ4C":
        return PackedQ4C(self.w.to(device), self.scale.to(device))


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 codes in [-8, 7] -> (N, K/2) bytes, even k in the low nibble."""
    u = codes.contiguous().view(torch.uint8)
    return ((u[:, 1::2] << 4) | (u[:, 0::2] & 15)).view(torch.int8)


def pack_q4c(w: torch.Tensor) -> PackedQ4C:
    """(K, N) float, on any device -> PackedQ4C there, with the tool's codes
    and scales (its ``pack_q4``). K must be even."""
    if w.shape[0] % 2:
        raise ValueError(f"pack_q4c packs two K rows per byte: K={w.shape[0]} is odd")
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=0) / 7.0, min=1e-8)
    codes = torch.clamp(torch.round(wf / scale[None, :]), -7, 7).to(torch.int8)
    return PackedQ4C(pack_nibbles(codes.t()), scale)


def random_q4c(k: int, n: int, gen: torch.Generator, device="cuda") -> PackedQ4C:
    """A random per-column weight made on ``device`` from ``gen``: codes in
    [-7, 7] and scales of a (K, N) weight of std ~0.02."""
    codes = torch.randint(-7, 8, (n, k), generator=gen, device=device, dtype=torch.int8)
    scale = (torch.rand((n,), generator=gen, device=device) + 0.5) * (0.02 * 3 / 7)
    return PackedQ4C(pack_nibbles(codes), scale)


def split_even_odd(x8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) -> the even and the odd K values, each (M, K/2) contiguous: the
    operands of T2, as the tool splits them."""
    pairs = x8.reshape(x8.shape[0], -1, 2)
    return pairs[..., 0].contiguous(), pairs[..., 1].contiguous()


def w4_int32_plain(x8: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of T2 and T3: (M, K) int8 x packed (N, K/2) -> (M, N)
    int32, exact (every partial sum is an integer below K * 127 * 8 < 2^53)."""
    return torch.matmul(x8.double(), unpack_q4(w).double().T).to(torch.int32)


def _check(xs, w, k: int, what: str) -> None:
    n, k2 = w.shape
    if k != 2 * k2 or w.dtype != torch.int8 or any(x.dtype != torch.int8 for x in xs):
        raise ValueError(f"{what} takes int8 activations of K={2 * k2} and packed (N, K/2) "
                         f"bytes: K={k}, w {tuple(w.shape)}")
    if k % 32:
        raise ValueError(f"{what} needs K % 32 == 0, got K={k}")
    for t in (*xs, w):
        if not (t.is_cuda and t.is_contiguous() and t.device == w.device
                and t.data_ptr() % 16 == 0):
            raise ValueError(f"{what} takes contiguous, 16-byte aligned CUDA operands on one "
                             f"device")


def w4_int32_split(xlo: torch.Tensor, xhi: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """T2: the even and the odd K values of the activations, each (M, K/2)
    int8, x packed (N, K/2) -> (M, N) int32. The kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    m = xlo.shape[0]
    if not xlo.is_cuda:
        x8 = torch.stack([xlo, xhi], dim=-1).reshape(m, -1)
        return w4_int32_plain(x8, w)
    if xhi.shape != xlo.shape:
        raise ValueError(f"T2 takes xlo and xhi of one shape: {xlo.shape} {xhi.shape}")
    _check((xlo, xhi), w, 2 * xlo.shape[1], "T2")
    out = torch.empty((m, w.shape[0]), dtype=torch.int32, device=w.device)
    fn = _build.load("w4_colscale").w4_int32_split_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(xlo.data_ptr(), xhi.data_ptr(), w.data_ptr(), out.data_ptr(), m, w.shape[0],
            2 * xlo.shape[1], torch.cuda.current_stream(w.device).cuda_stream)
    w4_int32_split.launches += 1
    _build.check(rc, "w4_int32_split_launch")
    return out


w4_int32_split.launches = 0


def w4_int32(x8: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """T3: (M, K) int8 x packed (N, K/2) -> (M, N) int32. The kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if not x8.is_cuda:
        return w4_int32_plain(x8, w)
    m, k = x8.shape
    _check((x8,), w, k, "T3")
    out = torch.empty((m, w.shape[0]), dtype=torch.int32, device=w.device)
    fn = _build.load("w4_colscale").w4_int32_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x8.data_ptr(), w.data_ptr(), out.data_ptr(), m, w.shape[0], k,
            torch.cuda.current_stream(w.device).cuda_stream)
    w4_int32.launches += 1
    _build.check(rc, "w4_int32_launch")
    return out


w4_int32.launches = 0

VARIANTS = ("w4", "w4p")     # the tool's names: T2 (split activations), T3 (whole)


def q4c_matmul(x: torch.Tensor, packed: PackedQ4C, variant: str = "w4p",
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """(..., K) float x PackedQ4C -> (..., N) out_dtype, through T2
    (``variant="w4"``) or T3 (``"w4p"``): f32(acc) * x_scale * scale, in
    the tool's order."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    lead, k = x.shape[:-1], x.shape[-1]
    x8, xs = quantize_act(x.reshape(-1, k))
    acc = w4_int32(x8, packed.w) if variant == "w4p" else w4_int32_split(
        *split_even_odd(x8), packed.w)
    y = acc.float() * xs[:, None] * packed.scale[None, :].float()
    return y.to(out_dtype).reshape(*lead, packed.n)
