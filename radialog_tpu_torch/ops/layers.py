"""Functional neural-net building blocks in PyTorch, NHWC at the interface.

Port of radialog_tpu/ops/layers.py. Parameters are plain dicts of tensors
with the JAX package's names and layouts (linear weights (in, out), conv
weights (kh, kw, Cin, Cout)), so a JAX parameter tree converts leaf by leaf
(radialog_tpu_torch/bridge.py). Convolutions permute to NCHW internally for
``torch.nn.functional.conv2d``.

Precision: TF32 is off for matmuls and cuDNN convolutions
(``set_precision``, called by every entry point that runs on a card), so a
float32 policy computes in full float32 on the card as on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def set_precision() -> None:
    """Full-float32 matmuls and convolutions: TF32 off for both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Parameter / compute / output dtypes."""

    param: torch.dtype = torch.float32
    compute: torch.dtype = torch.bfloat16
    output: torch.dtype = torch.float32

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute)


FP32 = DTypePolicy(param=torch.float32, compute=torch.float32, output=torch.float32)
BF16 = DTypePolicy()


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32 for the f32 math of norms, softmax and losses; an f64
    tensor stays f64, so that a float64 run of a path is float64 through."""
    return x if x.dtype == torch.float64 else x.float()


@functools.lru_cache(maxsize=256)
def _scalar(value: float, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    with torch.inference_mode(False):   # usable in autograd whoever made it first
        return torch.full((), value, dtype=dtype, device=device)


def div_scalar(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` as an IEEE division, as numpy, JAX and PyTorch's CPU
    divide, for an elementwise division whose result must agree bitwise
    across devices (dropout's mask replay). PyTorch's CUDA division by a
    Python scalar multiplies by the scalar's reciprocal, which rounds
    differently; the divisor here is a 0-dim tensor of x's dtype kept on
    each device, so no call copies it from the host."""
    return x / _scalar(float(value), x.device, x.dtype)


# --------------------------------------------------------------------- init
def normal(gen: torch.Generator, shape: Sequence[int], std: float,
           device, dtype=torch.float32) -> torch.Tensor:
    """N(0, std^2) draw from an explicit generator (on the generator's
    device), cast to ``dtype``."""
    x = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    return (x * std).to(dtype)


def normal_init(gen: torch.Generator, shape: Sequence[int], std: float = 1.0,
                device="cpu", dtype=torch.float32) -> torch.Tensor:
    """N(0, std^2) init draw, in the JAX package's argument order."""
    return normal(gen, shape, std, device, dtype)


def trunc_normal(gen: torch.Generator, shape: Sequence[int], std: float = 0.02,
                 device="cpu", dtype=torch.float32) -> torch.Tensor:
    """Normal draws truncated to (-2 std, 2 std) (timm's trunc_normal_
    convention), by rejection as the JAX package draws them: standard normal
    draws outside (-2, 2) are dropped and more are drawn until there are
    enough."""
    n = math.prod(shape)
    kept = torch.empty(0, device=device)
    while kept.numel() < n:     # ~4.6 % of draws fall outside
        draw = torch.randn(int(n * 1.1) + 16, generator=gen, device=device)
        kept = torch.cat([kept, draw[(draw > -2.0) & (draw < 2.0)]])
    return (std * kept[:n].reshape(tuple(shape))).to(dtype)


def linear_init(gen, in_dim: int, out_dim: int, device, bias: bool = True,
                dtype=torch.float32) -> dict:
    p = {"w": normal(gen, (in_dim, out_dim), in_dim ** -0.5, device, dtype)}
    if bias:
        p["b"] = torch.zeros(out_dim, device=device, dtype=dtype)
    return p


def conv2d_init(gen, in_ch: int, out_ch: int, kernel: int, device,
                bias: bool = False, dtype=torch.float32) -> dict:
    p = {"w": normal(gen, (kernel, kernel, in_ch, out_ch),
                     math.sqrt(2.0 / (in_ch * kernel * kernel)), device, dtype)}
    if bias:
        p["b"] = torch.zeros(out_ch, device=device, dtype=dtype)
    return p


def batchnorm_init(dim: int, device, dtype=torch.float32) -> Tuple[dict, dict]:
    params = {"scale": torch.ones(dim, device=device, dtype=dtype),
              "bias": torch.zeros(dim, device=device, dtype=dtype)}
    state = {"mean": torch.zeros(dim, device=device),
             "var": torch.ones(dim, device=device),
             "count": torch.zeros((), device=device)}
    return params, state


def layernorm_init(dim: int, device, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(dim, device=device, dtype=dtype),
            "bias": torch.zeros(dim, device=device, dtype=dtype)}


# ------------------------------------------------------------------- linear
def linear(p, x: torch.Tensor, policy: DTypePolicy = FP32) -> torch.Tensor:
    from .q4_matmul import PackedQ4, q4_matmul
    from .q8_matmul import PackedQ8, q8_matmul
    if isinstance(p, PackedQ8):  # W8A8 serving leaf: kernel K1 on a card
        return q8_matmul(x, p, out_dtype=policy.compute)
    if isinstance(p, PackedQ4):  # W4A8 serving leaf: kernel K4 on a card
        return q4_matmul(x, p, out_dtype=policy.compute)
    if "w_q" in p:  # unpacked int8 leaf of the training base (ops/quant.py)
        from .quant import linear_q8
        return linear_q8(p, x, compute_dtype=policy.compute)
    y = torch.matmul(policy.cast(x), policy.cast(p["w"]))
    if "b" in p:
        y = y + policy.cast(p["b"])
    return y


# ------------------------------------------------------------------- conv2d
def _same_pads(size: int, k: int, s: int, d: int) -> Tuple[int, int]:
    eff = (k - 1) * d + 1
    out = -(-size // s)
    total = max((out - 1) * s + eff - size, 0)
    return total // 2, total - total // 2


def conv2d(p: dict, x: torch.Tensor, stride=1, padding="SAME", dilation: int = 1,
           policy: DTypePolicy = FP32) -> torch.Tensor:
    """NHWC conv. ``x``: (B,H,W,C), weight: (kh,kw,Cin,Cout)."""
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    w = policy.cast(p["w"]).permute(3, 2, 0, 1)          # OIHW
    xc = policy.cast(x).permute(0, 3, 1, 2)              # NCHW
    kh, kw = w.shape[2], w.shape[3]
    if padding == "SAME":
        ph = _same_pads(xc.shape[2], kh, sh, dilation)
        pw = _same_pads(xc.shape[3], kw, sw, dilation)
    elif isinstance(padding, int):
        ph = pw = (padding, padding)
    else:
        ph, pw = (padding[0], padding[0]), (padding[1], padding[1])
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(xc, w, stride=(sh, sw), padding=(ph[0], pw[0]), dilation=dilation)
    else:
        y = F.conv2d(F.pad(xc, (pw[0], pw[1], ph[0], ph[1])), w, stride=(sh, sw),
                     dilation=dilation)
    y = y.permute(0, 2, 3, 1)
    if "b" in p:
        y = y + policy.cast(p["b"])
    return y


# -------------------------------------------------------------------- norms
def batchnorm(p: dict, s: dict, x: torch.Tensor, train: bool = False,
              momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm over all axes but the last.

    Eval (the default) normalizes with the running stats and returns y.
    ``train=True`` normalizes with the batch's mean and biased variance (in
    f32; f64 stays f64) and returns (y, new_state): the running stats move
    by ``run = (1 - m) * run + m * batch``, the variance's with the unbiased
    factor n / (n - 1) (n = x.numel() / x.shape[-1]), and ``count`` by 1,
    as torch's BatchNorm and the JAX package update them. The new state
    carries no autograd history."""
    xf = upcast(x)
    if train:
        dims = tuple(range(x.ndim - 1))
        mu = xf.mean(dims)
        var = xf.var(dims, unbiased=False)
        n = x.numel() / x.shape[-1]
        unbiased = var.detach() * (n / max(n - 1, 1))
        new_s = {"mean": (1 - momentum) * s["mean"] + momentum * mu.detach(),
                 "var": (1 - momentum) * s["var"] + momentum * unbiased,
                 "count": s["count"] + 1.0}
    else:
        mu, var = s["mean"].to(xf.dtype), s["var"].to(xf.dtype)
    inv = torch.rsqrt(var + eps)
    y = ((xf - mu) * inv * p["scale"].to(xf.dtype) + p["bias"].to(xf.dtype)).to(x.dtype)
    return (y, new_s) if train else y


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm in fp32 (f64 input: in f64), cast back to the input dtype."""
    xf = upcast(x)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(xf.dtype) + p["bias"].to(xf.dtype)
    return y.to(x.dtype)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LLaMA RMSNorm: fp32 variance, scale applied in the input dtype (the
    product promotes to the scale's dtype, as in the JAX package)."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * scale


# ---------------------------------------------------------------- misc ops
def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` as ``jnp.take(table, ids, axis=0)`` gives them: a
    negative id counts from the end, and an id outside the table reads a
    row of NaN (a 32000-row Vicuna table under vocab 32001 at ``<IMG>``,
    whose rows the image splice then overwrites). No index leaves the
    table."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    inside = (ids >= 0) & (ids < n)
    rows = table[torch.where(inside, ids, torch.zeros_like(ids))]
    return torch.where(inside[..., None], rows, torch.full_like(rows[:1], float("nan")))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU."""
    return F.gelu(x, approximate="none")


def dropout(x: torch.Tensor, rate: float, train: bool,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a Bernoulli(1 - rate) keep-mask drawn from
    ``gen`` (on x's device). The identity unless training with a rate above
    0 and a generator, as the JAX package's dropout without a key."""
    if not train or rate <= 0.0 or gen is None:
        return x
    return apply_dropout_mask(x, torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate,
                              rate)


def apply_dropout_mask(x: torch.Tensor, keep_mask: torch.Tensor, rate: float) -> torch.Tensor:
    """x divided by 1 - rate (``div_scalar``) where ``keep_mask``, else 0,
    in x's dtype: the JAX package's arithmetic, for any mask."""
    return torch.where(keep_mask, div_scalar(x, 1.0 - rate), torch.zeros_like(x)).to(x.dtype)


def max_pool2d(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """NHWC max pool (torch MaxPool2d semantics, -inf padding)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, window: int, stride: Optional[int] = None) -> torch.Tensor:
    stride = stride or window
    y = F.avg_pool2d(x.float().permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) -> (B,C)."""
    return x.mean(dim=(1, 2))
