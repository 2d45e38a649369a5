"""Plain reference of the report's image side, in float32: BioViL-T
(ResNet-50 trunk, 1x1 projector, the missing-prior embedding), ln_vision,
the BLIP-2 Q-Former's image-grounded pass, and the CheXpert findings
classifier. It reads the parameter trees of ``benchmark/weights.py`` and
imports nothing of the program.

``quant`` is a control's arithmetic: every convolution and linear layer
takes its weights (per output channel) and inputs (per row of a linear
layer, per tensor of a convolution) rounded to int8 (``"int8"``) or to
float8 e4m3 under the same scales (``"fp8"``; the largest magnitude maps
to 448), in float32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.llama import q_fp8

EPS_BN = 1e-5


def _q8(x: torch.Tensor, dim) -> torch.Tensor:
    """Symmetric int8 rounding of x, one scale over ``dim`` (None: the
    whole tensor), in float32."""
    a = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    s = torch.clamp(a / 127.0, min=1e-8)
    return torch.clamp(torch.round(x / s), -127, 127) * s


def _round(x: torch.Tensor, dim, quant: Optional[str]) -> torch.Tensor:
    if quant is None:
        return x
    if quant == "int8":
        return _q8(x, dim)
    if quant == "fp8":
        return q_fp8(x, dim)
    raise ValueError(f"unknown control arithmetic {quant!r}")


def conv(p: Dict, x: torch.Tensor, stride: int, pad: int, quant: Optional[str]) -> torch.Tensor:
    """NHWC convolution of weight (kh, kw, Cin, Cout) with symmetric padding."""
    w = _round(p["w"].float(), (0, 1, 2), quant)
    x = _round(x, None, quant)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    y = y.permute(0, 2, 3, 1)
    return y + p["b"].float() if "b" in p else y


def linear(p: Dict, x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    w = _round(p["w"].float(), 0, quant)
    x = _round(x, -1, quant)
    y = x @ w
    return y + p["b"].float() if "b" in p else y


def batchnorm(p: Dict, s: Dict, x: torch.Tensor) -> torch.Tensor:
    return ((x - s["mean"].float()) * torch.rsqrt(s["var"].float() + EPS_BN)
            * p["scale"].float() + p["bias"].float())


def layernorm(p: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()


def resnet50(p: Dict, s: Dict, x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H/32, W/32, 2048): torchvision's ResNet-50 (the
    stride on each stage's first 3x3), batch norm on its running stats."""
    y = torch.relu(batchnorm(p["bn1"], s["bn1"], conv(p["conv1"], x, 2, 3, quant)))
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    for stage in range(1, 5):
        for b, (bp, bs) in enumerate(zip(p[f"layer{stage}"], s[f"layer{stage}"])):
            stride = 2 if (b == 0 and stage > 1) else 1
            h = torch.relu(batchnorm(bp["bn1"], bs["bn1"], conv(bp["conv1"], y, 1, 0, quant)))
            h = torch.relu(batchnorm(bp["bn2"], bs["bn2"], conv(bp["conv2"], h, stride, 1, quant)))
            h = batchnorm(bp["bn3"], bs["bn3"], conv(bp["conv3"], h, 1, 0, quant))
            idn = (batchnorm(bp["down_bn"], bs["down_bn"], conv(bp["down_conv"], y, stride, 0,
                                                               quant))
                   if "down_conv" in bp else y)
            y = torch.relu(h + idn)
    return y


def biovil_patches(p: Dict, s: Dict, images: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """BioViL-T without a prior image: the projected patch embeddings
    (B, h, w, J)."""
    feats = conv(p["backbone_to_vit"], resnet50(p["resnet"], s["resnet"], images, quant), 1, 0,
                 quant)
    diff = p["missing_previous_emb"].float().expand(feats.shape)
    fused = torch.cat([feats, diff], dim=-1)
    proj = torch.relu(batchnorm(p["proj_bn"], s["proj_bn"], conv(p["proj1"], fused, 1, 0, quant)))
    return conv(p["proj2"], proj, 1, 0, quant)


def _attention(p: Dict, x: torch.Tensor, src: torch.Tensor, heads: int, eps: float,
               quant: Optional[str]) -> torch.Tensor:
    """Post-norm BERT attention block: LN(dense(softmax(q k^T / sqrt(d)) v) + x)."""
    b, t, hid = x.shape
    d = hid // heads
    q = linear(p["q"], x, quant).reshape(b, t, heads, d).transpose(1, 2)
    k = linear(p["k"], src, quant).reshape(b, -1, heads, d).transpose(1, 2)
    v = linear(p["v"], src, quant).reshape(b, -1, heads, d).transpose(1, 2)
    a = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5, dim=-1) @ v
    o = linear(p["out"], a.transpose(1, 2).reshape(b, t, hid), quant)
    return layernorm(p["out_ln"], o + x, eps)


def qformer_queries(vp: Dict, vs: Dict, qf: Dict, vision: Dict, images: torch.Tensor,
                    quant: Optional[str] = None) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> the Q-Former's query embeddings
    (B, n_query, hidden) from the weights of ``vision_weights`` (vp, vs)
    and ``qformer_weights`` (qf): BioViL-T, its patch tokens in the channel-major
    order the released Q-Former reads (the NCHW map reshaped straight to
    (B, h*w, J)), ln_vision, then per layer self-attention, cross-attention
    to the patches where the layer has it, and the query FFN."""
    q = vision["qformer"]
    patch = biovil_patches(vp, vs, images, quant)
    b, h, w, c = patch.shape
    tokens = patch.permute(0, 3, 1, 2).reshape(b, h * w, c)
    tokens = layernorm(qf["ln_vision"], tokens, 1e-12)
    p = qf["qformer"]
    eps = q["layer_norm_eps"]
    x = layernorm(p["embeddings"]["ln"], p["query_tokens"].float()[None].expand(b, -1, -1), eps)
    for lp in p["layers"]:
        x = _attention(lp["attn"], x, x, q["num_heads"], eps, quant)
        if "cross" in lp:
            x = _attention(lp["cross"], x, tokens, q["num_heads"], eps, quant)
        f = lp["ffn_query"]
        hid = F.gelu(linear(f["inter"], x, quant))
        x = layernorm(f["out_ln"], linear(f["out"], hid, quant) + x, eps)
    return x


def classifier_logits(cp: Dict, cs: Dict, vision: Dict, images: torch.Tensor,
                      quant: Optional[str] = None) -> torch.Tensor:
    """(B, S, S, 3) -> the 14 findings' logits: BioViL-T's projected patches
    (joint width 128), 4 x 4 average pooling, the NCHW flatten, fc1, ReLU,
    fc2."""
    patch = biovil_patches(cp["biovil"], cs["biovil"], images, quant)
    pooled = F.avg_pool2d(patch.permute(0, 3, 1, 2), 4, 4)
    x = pooled.reshape(pooled.shape[0], -1)
    return linear(cp["fc2"], torch.relu(linear(cp["fc1"], x, quant)), quant)
