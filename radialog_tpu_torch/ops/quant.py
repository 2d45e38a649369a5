"""Host-side W8A8 packing of LLaMA weights into the serving layout (port of
radialog_tpu/ops/quant.py ``quantize_llama_host``, bits=8, fuse=True).

Projections become ``PackedQ8`` leaves (ops/q8_matmul.py); q|k|v and
gate|up are concatenated into single matmuls; layers are a list of
per-layer dicts (the unrolled serving path of models/llama.py).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .q8_matmul import PackedQ8, pack_q8


def quantize_llama_host(params: Dict, device="cuda") -> Dict:
    """Stacked float LLaMA params (numpy or tensors, leaves with a leading
    layer axis as ``llama_init`` builds them) -> serving params on
    ``device``. Quantization runs on the host, so the float copy never
    lives on the card."""
    def host(x):
        return x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x, np.float32)

    def put(x, dtype=torch.float32):
        return torch.tensor(host(x)).to(device=device, dtype=dtype)

    def put_packed(p: PackedQ8) -> PackedQ8:
        return p.to(device)

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
            "wqkv": put_packed(pack_q8(wqkv)),
            "gateup": put_packed(pack_q8(gateup)),
            "wo": put_packed(pack_q8(host(src["wo"]["w"])[i])),
            "down": put_packed(pack_q8(host(src["down"]["w"])[i])),
        })
    out = {"final_ln": put(params["final_ln"]), "layers": layers,
           "lm_head": put_packed(pack_q8(host(params["lm_head"]["w"]))),
           "embed": put(params["embed"], torch.bfloat16)}
    if "img_proj" in params:
        out["img_proj"] = {k: put(v) for k, v in params["img_proj"].items()}
    return out


def random_serving_params(cfg, gen: torch.Generator, device="cuda") -> Dict:
    """Serving params at ``cfg``'s widths with random int8 weights made
    directly on ``device`` from ``gen`` (no float copy: 6.7 GB of int8 at
    Vicuna-7B). Per-channel scales ~1/(73 sqrt(K)) keep activations of
    unit scale through the depth (uniform int8 has std ~73)."""
    h, inter, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kvh = cfg.num_kv_heads * cfg.head_dim

    def leaf(k: int, n: int) -> PackedQ8:
        w = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)
        jitter = torch.rand((n,), generator=gen, device=device) + 0.5
        return PackedQ8(w, jitter / (73.0 * k ** 0.5))

    layers = [{"input_ln": torch.ones(h, device=device),
               "post_ln": torch.ones(h, device=device),
               "wqkv": leaf(h, h + 2 * kvh), "wo": leaf(h, h),
               "gateup": leaf(h, 2 * inter), "down": leaf(inter, h)}
              for _ in range(cfg.num_layers)]
    embed = torch.randn((V, h), generator=gen, device=device) * 0.02
    return {"embed": embed.to(torch.bfloat16), "layers": layers,
            "final_ln": torch.ones(h, device=device), "lm_head": leaf(h, V)}
