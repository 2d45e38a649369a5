"""Host-side packing of LLaMA weights into the serving layout (port of
radialog_tpu/ops/quant.py ``quantize_llama_host``, fuse=True).

Projections become ``PackedQ8`` leaves (ops/q8_matmul.py) or, at ``bits=4``,
``PackedQ4`` leaves (ops/q4_matmul.py); q|k|v and gate|up are concatenated
into single matmuls; layers are a list of per-layer dicts (the unrolled
serving path of models/llama.py). The lm_head stays int8 at either width:
it decides the argmax.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from .q4_matmul import GROUP, PackedQ4, pack_q4, pick_bk
from .q8_matmul import PackedQ8, pack_q8


def _check_bits(bits: int, w4_mode: str) -> None:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if w4_mode not in ("asym", "sym"):
        raise ValueError(f"w4_mode must be 'asym' or 'sym', got {w4_mode!r}")


def quantize_llama_host(params: Dict, device="cuda", bits: int = 8,
                        w4_mode: str = "asym") -> Dict:
    """Stacked float LLaMA params (numpy or tensors, leaves with a leading
    layer axis as ``llama_init`` builds them) -> serving params on
    ``device``. Quantization runs on the host, so the float copy never
    lives on the card. ``bits=4`` packs the layer projections as PackedQ4
    on the ``w4_mode`` grid ("asym": MSE-optimal clipped asymmetric, "sym":
    symmetric absmax)."""
    _check_bits(bits, w4_mode)
    pack_layer = functools.partial(pack_q4, mode=w4_mode) if bits == 4 else pack_q8

    def host(x):
        return x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x, np.float32)

    def put(x, dtype=torch.float32):
        return torch.tensor(host(x)).to(device=device, dtype=dtype)

    src = params["layers"]
    num_layers = host(src["wq"]["w"]).shape[0]
    layers = []
    for i in range(num_layers):
        wqkv = np.concatenate([host(src["wq"]["w"])[i], host(src["wk"]["w"])[i],
                               host(src["wv"]["w"])[i]], axis=-1)
        gateup = np.concatenate([host(src["gate"]["w"])[i], host(src["up"]["w"])[i]],
                                axis=-1)
        layers.append({
            "input_ln": put(host(src["input_ln"])[i]),
            "post_ln": put(host(src["post_ln"])[i]),
            "wqkv": pack_layer(wqkv).to(device),
            "gateup": pack_layer(gateup).to(device),
            "wo": pack_layer(host(src["wo"]["w"])[i]).to(device),
            "down": pack_layer(host(src["down"]["w"])[i]).to(device),
        })
    out = {"final_ln": put(params["final_ln"]), "layers": layers,
           "lm_head": pack_q8(host(params["lm_head"]["w"])).to(device),
           "embed": put(params["embed"], torch.bfloat16)}
    if "img_proj" in params:
        out["img_proj"] = {k: put(v) for k, v in params["img_proj"].items()}
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
