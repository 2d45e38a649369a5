"""Parameters of the JAX package, handed over as nested dicts/lists of numpy
arrays, turned into the port's parameters.

The port keeps the JAX package's tree layout and names (linear weights
(in, out), conv weights (kh, kw, Cin, Cout), stacked LLaMA/LoRA leaves), so
most of a tree converts leaf by leaf. The one layout that changes is the
W8A8 weight: the TPU's (kt, nt, bk, bn) int8 tiles, padded in K and N, are
unpacked into the port's (N, K) rows. The port never sees a JAX object:
callers convert with ``np.asarray`` on their side.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .ops.q8_matmul import PackedQ8


def to_torch(tree: Any, device="cpu") -> Any:
    """numpy leaves (bfloat16 included) -> tensors; dicts/lists/tuples kept."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)   # a writable copy


def packed_q8(d: Dict, k: int, device="cpu") -> PackedQ8:
    """A JAX PackedQ8 as {"w_t" (kt,nt,bk,bn) int8, "scale" (Np,), "n", "b"}
    with true input width ``k`` -> PackedQ8 (N, K) int8 rows."""
    w_t = np.asarray(d["w_t"])
    kt, nt, bk, bn = w_t.shape
    n = int(d["n"])
    w = w_t.transpose(0, 2, 1, 3).reshape(kt * bk, nt * bn)[:k, :n]
    scale = np.asarray(d["scale"], np.float32)[:n]
    b = d.get("b")
    return PackedQ8(torch.from_numpy(np.ascontiguousarray(w.T)).to(device),
                    torch.from_numpy(scale.copy()).to(device),
                    None if b is None else to_torch(np.asarray(b)[:n], device))


def llama_serving(tree: Dict, cfg, device="cpu") -> Dict:
    """quantize_llama_host(bits=8, fuse=True) output, with each PackedQ8 as
    a dict (see ``packed_q8``) -> the port's serving params."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    k_of = {"wqkv": h, "wo": h, "gateup": h, "down": inter}
    layers = []
    for lp in tree["layers"]:
        layer = {name: packed_q8(lp[name], k, device) for name, k in k_of.items()}
        layer["input_ln"] = to_torch(lp["input_ln"], device)
        layer["post_ln"] = to_torch(lp["post_ln"], device)
        layers.append(layer)
    out = {"layers": layers, "final_ln": to_torch(tree["final_ln"], device),
           "lm_head": packed_q8(tree["lm_head"], h, device),
           "embed": to_torch(tree["embed"], device)}
    if "img_proj" in tree:
        out["img_proj"] = to_torch(tree["img_proj"], device)
    return out


def llama(params: Dict, device="cpu") -> Dict:
    """llama_init's stacked float tree (for ops/quant.quantize_llama_host)."""
    return to_torch(params, device)


def lora(tree: Dict, device="cpu") -> Dict:
    """lora_init's tree: stacked a/b per target, img_proj and the scale."""
    return to_torch(tree, device)


def biovil_t(params: Dict, state: Dict, device="cpu") -> Tuple[Dict, Dict]:
    """biovil_t_init's (params, batchnorm state)."""
    return to_torch(params, device), to_torch(state, device)


def qformer(qformer_params: Dict, ln_vision: Dict, device="cpu") -> Dict:
    """qformer_init's tree plus ln_vision -> the params blip2_forward_image
    reads ({"qformer", "ln_vision"})."""
    return {"qformer": to_torch(qformer_params, device),
            "ln_vision": to_torch(ln_vision, device)}


def chexpert(params: Dict, state: Dict, device="cpu") -> Tuple[Dict, Dict]:
    """chexpert_classifier_init's (params, state)."""
    return to_torch(params, device), to_torch(state, device)
