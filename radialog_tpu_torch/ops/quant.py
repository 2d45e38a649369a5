"""Int8 weights of the LLaMA projections (port of radialog_tpu/ops/quant.py).

Two layouts. The training layout (``quantize_weight``, ``quantize_llama``,
``quantize_llama_np``, ``random_q8_train_base``) keeps the stacked tree of
``llama_init`` and replaces each projection leaf by ``{"w_q" (..., in, out)
int8, "scale" (..., out) f32}``: the frozen base of LoRA finetuning, which
``linear_q8`` multiplies as ``(x @ w_q) * scale`` and differentiates in x
only. The serving layout (``quantize_llama_host``, fuse=True) is packed
layer by layer: projections become ``PackedQ8`` leaves (ops/q8_matmul.py) or, at
``bits=4``, ``PackedQ4`` leaves (ops/q4_matmul.py); q|k|v and gate|up are concatenated
into single matmuls; layers are a list of per-layer dicts (the unrolled
serving path of models/llama.py). The lm_head stays int8 at either width:
it decides the argmax.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List

import numpy as np
import torch

from .q4_matmul import GROUP, PackedQ4, pack_q4, pick_bk
from .q8_matmul import PackedQ8, div127, pack_q8


_QUANT_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., in, out) float -> {"w_q": int8, "scale": f32 per out channel}."""
    wf = w.float()
    scale = torch.clamp(div127(wf.abs().amax(dim=-2, keepdim=True)), min=1e-8)
    w_q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"w_q": w_q, "scale": scale.squeeze(-2)}


def dequantize_weight(q: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    return (q["w_q"].float() * q["scale"][..., None, :]).to(dtype)


def is_quantized(p: Any) -> bool:
    return isinstance(p, dict) and "w_q" in p


class _LinearQ8(torch.autograd.Function):
    """y = (x @ w_q) * scale in the compute dtype, differentiable in x only.
    The backward dequantizes the int8 weight again instead of keeping its
    compute-dtype copy alive (at Vicuna-7B widths autograd would otherwise
    hold up to 90 MB per projection until the layer's backward)."""

    @staticmethod
    def forward(ctx, x, w_q, scale):
        ctx.save_for_backward(w_q, scale)
        return torch.matmul(x, w_q.to(x.dtype)) * scale

    @staticmethod
    def backward(ctx, dy):
        w_q, scale = ctx.saved_tensors
        return torch.matmul(dy * scale, w_q.to(dy.dtype).transpose(-1, -2)), None, None


def linear_q8(q: Dict[str, torch.Tensor], x: torch.Tensor,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The unpacked int8 leaf: y = (x @ w_q) * scale (+ b), products and
    result in ``compute_dtype``. This product is outside any Pallas kernel
    in the JAX package too (XLA's dot), so it is ``torch.matmul``."""
    y = _LinearQ8.apply(x.to(compute_dtype), q["w_q"], q["scale"].to(compute_dtype))
    if "b" in q:
        y = y + q["b"].to(compute_dtype)
    return y


def quantize_llama(params: Dict, quantize_embed: bool = True) -> Dict:
    """Stacked LLaMA tree -> the same tree with the projection leaves as
    {"w_q", "scale"}. Norms stay float; with ``quantize_embed`` the lm_head
    is quantized too and the embedding table kept in bf16."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in _QUANT_TARGETS:
        layers[name] = quantize_weight(layers[name]["w"])
    out["layers"] = layers
    if quantize_embed:
        out["lm_head"] = quantize_weight(params["lm_head"]["w"])
        out["embed"] = params["embed"].to(torch.bfloat16)
    return out


def _per_layer(layers) -> List[Dict]:
    """``layers`` as a list of per-layer trees: a list as it is; a stacked
    tree (leaves with a leading layer axis) sliced to views, one a layer."""
    if isinstance(layers, (list, tuple)):
        return list(layers)

    def take(tree, i):
        return {k: take(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}
    return [take(layers, i) for i in range(len(layers["wq"]["w"]))]


def quantize_llama_np(params: Dict, device="cuda", quantize_embed: bool = True) -> Dict:
    """``quantize_llama`` from a host tree (numpy arrays or CPU tensors;
    ``layers`` stacked or a list of per-layer trees), quantized on
    ``device`` one layer of a leaf at a time, so the float copy of the
    whole model never lives on the card (the same bytes as on the host: a
    max, an IEEE division and round half to even). Norms become f32."""
    def host(x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.array(np.asarray(x, np.float32)))

    def put(x, dtype=None):
        return host(x).to(device=device, dtype=dtype)

    def put_q(w):
        return quantize_weight(host(w).to(device))

    def stacked(leaves):
        return ({k: torch.stack([x[k] for x in leaves]) for k in leaves[0]}
                if isinstance(leaves[0], dict) else torch.stack(leaves))

    src = _per_layer(params["layers"])
    layers = {name: stacked([put_q(lay[name]["w"]) for lay in src]) for name in _QUANT_TARGETS}
    layers["input_ln"] = stacked([put(lay["input_ln"], torch.float32) for lay in src])
    layers["post_ln"] = stacked([put(lay["post_ln"], torch.float32) for lay in src])
    out = {"layers": layers, "final_ln": put(params["final_ln"], torch.float32)}
    if quantize_embed:
        out["lm_head"] = put_q(params["lm_head"]["w"])
        out["embed"] = put(params["embed"], torch.bfloat16)
    else:
        out["lm_head"] = {"w": put(params["lm_head"]["w"])}
        out["embed"] = put(params["embed"])
    if "img_proj" in params:
        out["img_proj"] = {k: put(v) for k, v in params["img_proj"].items()}
    return out


def random_q8_train_base(cfg, gen: torch.Generator, device="cuda") -> Dict:
    """The stacked {"w_q", "scale"} training base at ``cfg``'s widths with
    random int8 weights drawn on ``device`` from ``gen``, one int8 leaf at a
    time (no int32 or float copy of a leaf: 6.6 GB of int8 at Vicuna-7B).
    Scales ~1/(73 sqrt(K)) keep activations of unit scale through the depth
    (uniform int8 has std ~73). Every weight is random, the lm_head too, so
    hidden states differ per token and the gradient norm is a live signal."""
    h, inter, L, V = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    kvh = cfg.num_kv_heads * cfg.head_dim

    def leaf(k: int, n: int, stacked: bool = True) -> Dict[str, torch.Tensor]:
        lead = (L,) if stacked else ()
        w = torch.randint(-127, 128, lead + (k, n), generator=gen, device=device,
                          dtype=torch.int8)
        jitter = torch.rand(lead + (n,), generator=gen, device=device) + 0.5
        return {"w_q": w, "scale": jitter / (73.0 * k ** 0.5)}

    layers = {"wq": leaf(h, h), "wk": leaf(h, kvh), "wv": leaf(h, kvh), "wo": leaf(h, h),
              "gate": leaf(h, inter), "up": leaf(h, inter), "down": leaf(inter, h),
              "input_ln": torch.ones((L, h), device=device),
              "post_ln": torch.ones((L, h), device=device)}
    embed = torch.randn((V, h), generator=gen, device=device) * 0.02
    return {"embed": embed.to(torch.bfloat16), "layers": layers,
            "final_ln": torch.ones(h, device=device), "lm_head": leaf(h, V, stacked=False)}


def _check_bits(bits: int, w4_mode: str) -> None:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if w4_mode not in ("asym", "sym"):
        raise ValueError(f"w4_mode must be 'asym' or 'sym', got {w4_mode!r}")


def quantize_llama_host(params: Dict, device="cuda", bits: int = 8,
                        w4_mode: str = "asym") -> Dict:
    """Float LLaMA params (numpy or tensors; ``layers`` stacked as
    ``llama_init`` builds them, or a list of per-layer trees as
    ``utils/hf_weights.convert_llama(stack=False)`` reads a checkpoint) ->
    serving params on ``device``, one layer at a time: each leaf is sliced
    to the layer before it is converted, so no whole stack is ever copied.
    ``bits=8`` packs each layer on ``device`` itself (``pack_q8`` of a
    tensor: the layer's float weights are the only float copy there, and
    the bytes are the host packer's); ``bits=4`` packs on the host as
    PackedQ4 on the ``w4_mode`` grid ("asym": MSE-optimal clipped
    asymmetric, "sym": symmetric absmax) and moves the result."""
    _check_bits(bits, w4_mode)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:   # the caller's card, also in the workers
        dev = torch.device("cuda", torch.cuda.current_device())

    def f32(x):   # a tensor on ``device`` in f32 (numpy leaves keep their values)
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return x.to(dev).float()

    def f32_host(x):
        return x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x, np.float32)

    def pack_layer(*ws):
        if bits == 4:
            w = np.concatenate([f32_host(x) for x in ws], axis=-1)
            return pack_q4(w, mode=w4_mode).to(dev)
        return pack_q8(torch.cat([f32(x) for x in ws], dim=-1))

    def leaves(lay):
        return {"wqkv": (lay["wq"]["w"], lay["wk"]["w"], lay["wv"]["w"]),
                "gateup": (lay["gate"]["w"], lay["up"]["w"]),
                "wo": (lay["wo"]["w"],), "down": (lay["down"]["w"],)}

    # pack_q4's grid fits are numpy array work, which releases the GIL: at 4
    # bits the four projections of a layer pack in threads (the bytes of a
    # serial run); at 8 bits pack_q8 runs on the device, in this thread
    with ThreadPoolExecutor(4) as pool:
        run = pool.map if bits == 4 else map
        layers = []
        for lay in _per_layer(params["layers"]):
            groups = leaves(lay)
            packed = run(lambda ws: pack_layer(*ws), groups.values())
            layers.append({"input_ln": f32(lay["input_ln"]), "post_ln": f32(lay["post_ln"]),
                           **dict(zip(groups, packed))})
    out = {"final_ln": f32(params["final_ln"]), "layers": layers,
           "lm_head": pack_q8(f32(params["lm_head"]["w"])),
           "embed": f32(params["embed"]).to(torch.bfloat16)}
    if "img_proj" in params:
        out["img_proj"] = {k: f32(v) for k, v in params["img_proj"].items()}
    return out


def random_serving_params(cfg, gen: torch.Generator, device="cuda", bits: int = 8,
                          w4_mode: str = "asym") -> Dict:
    """Serving params at ``cfg``'s widths with random quantized weights made
    directly on ``device`` from ``gen`` (no float copy: 6.7 GB of int8 at
    Vicuna-7B, half of that in int4 layers). Scales keep activations of unit
    scale through the depth: per channel ~1/(73 sqrt(K)) for int8 (uniform
    int8 has std ~73), per group ~1/(4.6 sqrt(K)) for int4 (uniform codes in
    [-8, 7] have std ~4.6) with offsets within half a step. The lm_head is
    int8 at either width."""
    _check_bits(bits, w4_mode)
    h, inter, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kvh = cfg.num_kv_heads * cfg.head_dim

    def leaf8(k: int, n: int) -> PackedQ8:
        w = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)
        jitter = torch.rand((n,), generator=gen, device=device) + 0.5
        return PackedQ8(w, jitter / (73.0 * k ** 0.5))

    def leaf4(k: int, n: int) -> PackedQ4:
        bk = pick_bk(k)
        group = GROUP if bk % GROUP == 0 else bk
        groups = -(-k // bk) * bk // group
        low = -8 if w4_mode == "asym" else -7
        lo, hi = (torch.randint(low, 8, (n, k // 2), generator=gen, device=device,
                                dtype=torch.int8) for _ in range(2))
        gscale = (torch.rand((groups, n), generator=gen, device=device) + 0.5) \
            / (4.6 * k ** 0.5)
        goff = None
        if w4_mode == "asym":
            goff = (torch.rand((groups, n), generator=gen, device=device) - 0.5) * gscale
        return PackedQ4((hi << 4) | (lo & 15), gscale, group, goff)

    leaf = leaf4 if bits == 4 else leaf8
    layers = [{"input_ln": torch.ones(h, device=device),
               "post_ln": torch.ones(h, device=device),
               "wqkv": leaf(h, h + 2 * kvh), "wo": leaf(h, h),
               "gateup": leaf(h, 2 * inter), "down": leaf(inter, h)}
              for _ in range(cfg.num_layers)]
    embed = torch.randn((V, h), generator=gen, device=device) * 0.02
    return {"embed": embed.to(torch.bfloat16), "layers": layers,
            "final_ln": torch.ones(h, device=device), "lm_head": leaf8(h, V)}
