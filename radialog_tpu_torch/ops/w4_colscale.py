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
tensor each launches its kernel of csrc/w4_colscale.cu (TMA and an int8
wgmma whose A operand is the weight's nibbles unpacked in registers, with
the operands swapped: C^T = Q . X^T), on a CPU tensor both run the one
plain version ``w4_int32_plain``. Integer sums are exact, so kernel and
plain version agree bit for bit. ``_plan`` chooses the launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from . import _build
from .layers import div_scalar
# the ring that T2/T3 share with K4 (csrc/w4_tma.cuh), and its limits
from .q4_matmul import KTILE, SLOTS_PER_SM, SMEM_PER_SM, STAGES, WNS, unpack_q4
from .q8_matmul import SM_COUNT, _split, quantize_act

MAX_K = 131040               # the kernels sum 16 q x in int32: K * 2^14 < 2^31, K % 32 == 0


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
    and scales (its ``pack_q4``) bit for bit: the scale is an IEEE division
    by 7 (``div_scalar``; the card would multiply by the reciprocal of a
    Python scalar). K must be even."""
    if w.shape[0] % 2:
        raise ValueError(f"pack_q4c packs two K rows per byte: K={w.shape[0]} is odd")
    wf = w.float()
    scale = torch.clamp(div_scalar(wf.abs().amax(dim=0), 7.0), min=1e-8)
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
    if k > MAX_K:
        raise ValueError(f"{what} sums 16 q x products in int32: K={k} > {MAX_K}")
    for t in (*xs, w):
        if not (t.is_cuda and t.is_contiguous() and t.device == w.device
                and t.data_ptr() % 16 == 0):
            raise ValueError(f"{what} takes contiguous, 16-byte aligned CUDA operands on one "
                             f"device")


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of T2 or T3: ``wn`` activation rows (wgmma's N) by ``rows``
    weight rows (64 per consumer warpgroup) a block, a ring of ``stages``,
    K cut into ``splits`` ranges of ``per`` tiles of KTILE values, whose
    int32 sums are added with atomics into a zeroed output when there is
    more than one."""

    wn: int
    rows: int
    stages: int
    splits: int
    per: int

    def tiles(self, m: int, n: int) -> int:
        return -(-m // self.wn) * -(-n // self.rows)

    def smem(self) -> int:
        """Shared memory a block takes: the ring, its mbarriers, alignment."""
        return self.stages * 128 * (self.rows + 2 * self.wn) + 16 * self.stages + 1024


def _plan(m: int, n: int, k: int, rows: Optional[int] = None) -> Plan:
    """The launch for (M, K) activations x (N, K/2) packed weights. wn is the
    least of 8, 16, 32, 64 that holds the rows (64 above 64 rows, which are
    tiled over the grid). 64 weight rows a block (one consumer warpgroup,
    the most blocks), unless those tiles would not fit the card's 2 x 132
    slots at once: then 128 (two warpgroups share each stage of
    activations), which halves them; ``rows`` forces either. The ring is as
    deep as ~100 KB allows, two blocks an SM. K is split (K1's rule,
    ``q8_matmul._split``) only where the output tiles leave the slots half
    empty, into as many ranges as fit the slots, each at least 4 tiles
    deep. Measured on an H100 at M = 32 (PERF.md): 64-row blocks spare
    wqkv its K split and its zeroing and give wo and down twice the blocks;
    gateup's 344 such tiles would take two waves."""
    wn = next(w for w in WNS if min(m, WNS[-1]) <= w)
    slots = SLOTS_PER_SM * SM_COUNT
    if rows is None:
        rows = 64 if -(-m // wn) * -(-n // 64) <= slots else 128
    tiles = -(-m // wn) * -(-n // rows)
    splits, per = _split(tiles, -(-k // KTILE), slots)
    return Plan(wn, rows, STAGES[rows][wn], splits, per)


def _launch(split: bool, xs, w: torch.Tensor, m: int, k: int, plan: Plan) -> torch.Tensor:
    """Launch T2 (``split``, xs = (xlo, xhi)) or T3 (xs = (x8,)) with
    ``plan``, counting the launch on its wrapper; raise on a failed launch."""
    n = w.shape[0]
    out = (torch.zeros if plan.splits > 1 else torch.empty)((m, n), dtype=torch.int32,
                                                            device=w.device)
    name = "w4_int32_split_launch" if split else "w4_int32_launch"
    fn = getattr(_build.load("w4_colscale"), name)
    fn.argtypes = [ctypes.c_void_p] * (len(xs) + 2) + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(*(x.data_ptr() for x in xs), w.data_ptr(), out.data_ptr(), m, n, k, plan.wn,
            plan.rows, plan.stages, plan.per, torch.cuda.current_stream(w.device).cuda_stream)
    (w4_int32_split if split else w4_int32).launches += 1
    _build.check(rc, name)
    return out


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
    k = 2 * xlo.shape[1]
    _check((xlo, xhi), w, k, "T2")
    return _launch(True, (xlo, xhi), w, m, k, _plan(m, w.shape[0], k))


w4_int32_split.launches = 0


def w4_int32(x8: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """T3: (M, K) int8 x packed (N, K/2) -> (M, N) int32. The kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if not x8.is_cuda:
        return w4_int32_plain(x8, w)
    m, k = x8.shape
    _check((x8,), w, k, "T3")
    return _launch(False, (x8,), w, m, k, _plan(m, w.shape[0], k))


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
