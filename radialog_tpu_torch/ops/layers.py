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


# --------------------------------------------------------------------- init
def normal(gen: torch.Generator, shape: Sequence[int], std: float,
           device, dtype=torch.float32) -> torch.Tensor:
    """N(0, std^2) draw from an explicit generator (on the generator's
    device), cast to ``dtype``."""
    x = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    return (x * std).to(dtype)


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
def batchnorm(p: dict, s: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm over all axes but the last (running stats)."""
    xf = x.float()
    inv = torch.rsqrt(s["var"].float() + eps)
    y = (xf - s["mean"].float()) * inv * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm in fp32, cast back to the input dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LLaMA RMSNorm: fp32 variance, scale applied in the input dtype (the
    product promotes to the scale's dtype, as in the JAX package)."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * scale


# ---------------------------------------------------------------- misc ops
def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.long()]


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU."""
    return F.gelu(x, approximate="none")


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
