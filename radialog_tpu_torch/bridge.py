"""Parameters of the JAX package, handed over as nested dicts/lists of numpy
arrays, turned into the port's parameters.

The port keeps the JAX package's tree layout and names (linear weights
(in, out), conv weights (kh, kw, Cin, Cout), stacked LLaMA/LoRA leaves), so
most of a tree converts leaf by leaf. The one layout that changes is the
W8A8 weight: the TPU's (kt, nt, bk, bn) int8 tiles, padded in K and N, are
unpacked into the port's (N, K) rows, and likewise the W4A8 weight's
(kt, nt, bk/2, bn) nibble tiles into (N, K/2) rows. The port never sees a
JAX object: callers convert with ``np.asarray`` on their side.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .ops.q4_matmul import PackedQ4
from .ops.q8_matmul import PackedQ8


def to_torch(tree: Any, device="cuda") -> Any:
    """numpy leaves (bfloat16 included) -> tensors; dicts/lists/tuples kept."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)   # a writable copy


def packed_q8(d: Dict, k: int, device="cuda") -> PackedQ8:
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


def packed_q4(d: Dict, k: int, device="cuda") -> PackedQ4:
    """A JAX PackedQ4 as {"w_t" (kt,nt,bk/2,bn) int8 nibble pairs, "gscale"
    and "goff" (G, Np) f32 (goff None on the symmetric grid), "n", "group",
    "b"} with true input width ``k`` -> PackedQ4 (N, K/2) byte rows. The
    scales keep every group of the padded K."""
    w_t = np.asarray(d["w_t"])
    kt, nt, bk2, bn = w_t.shape
    n = int(d["n"])
    w = w_t.transpose(0, 2, 1, 3).reshape(kt * bk2, nt * bn)[:k // 2, :n]
    b, goff = d.get("b"), d.get("goff")

    def scales(x):
        return torch.from_numpy(np.array(np.asarray(x, np.float32)[:, :n])).to(device)
    return PackedQ4(torch.from_numpy(np.ascontiguousarray(w.T)).to(device),
                    scales(d["gscale"]), int(d["group"]),
                    None if goff is None else scales(goff),
                    None if b is None else to_torch(np.asarray(b)[:n], device))


def llama_serving(tree: Dict, cfg, device="cuda") -> Dict:
    """quantize_llama_host(bits=8 or 4, fuse=True) output, with each
    PackedQ8 / PackedQ4 as a dict (see ``packed_q8`` and ``packed_q4``; a
    dict with "gscale" is a PackedQ4) -> the port's serving params."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    k_of = {"wqkv": h, "wo": h, "gateup": h, "down": inter}

    def packed(d, k):
        return (packed_q4 if "gscale" in d else packed_q8)(d, k, device)
    layers = []
    for lp in tree["layers"]:
        layer = {name: packed(lp[name], k) for name, k in k_of.items()}
        layer["input_ln"] = to_torch(lp["input_ln"], device)
        layer["post_ln"] = to_torch(lp["post_ln"], device)
        layers.append(layer)
    out = {"layers": layers, "final_ln": to_torch(tree["final_ln"], device),
           "lm_head": packed_q8(tree["lm_head"], h, device),
           "embed": to_torch(tree["embed"], device)}
    if "img_proj" in tree:
        out["img_proj"] = to_torch(tree["img_proj"], device)
    return out


def llama(params: Dict, device="cuda") -> Dict:
    """llama_init's stacked float tree (for ops/quant.quantize_llama_host)."""
    return to_torch(params, device)


def lora(tree: Dict, device="cuda") -> Dict:
    """lora_init's tree: stacked a/b per target, img_proj and the scale."""
    return to_torch(tree, device)


def llama_stacked(tree: Dict, device="cuda") -> Dict:
    """The stacked training tree, float (llama_init) or with the
    {"w_q", "scale"} leaves of quantize_llama / quantize_llama_np: the port
    keeps both layouts as they are."""
    return to_torch(tree, device)


def adamw_state(state: Dict, device="cuda") -> Dict:
    """The optimizer state of train/optim.make_adamw from numpy: {"count",
    "mu", "nu"}, or with accumulation {"mini_step", "gradient_step", "acc",
    "inner": {...}}. Counters become Python ints."""
    out = {}
    for k, v in state.items():
        if k in ("count", "mini_step", "gradient_step"):
            out[k] = int(v)
        elif k == "inner":
            out[k] = adamw_state(v, device)
        else:
            out[k] = to_torch(v, device)
    return out


def biovil_t(params: Dict, state: Dict, device="cuda") -> Tuple[Dict, Dict]:
    """biovil_t_init's (params, batchnorm state)."""
    return to_torch(params, device), to_torch(state, device)


def qformer(qformer_params: Dict, ln_vision: Dict, device="cuda") -> Dict:
    """qformer_init's tree plus ln_vision -> the params blip2_forward_image
    reads ({"qformer", "ln_vision"})."""
    return {"qformer": to_torch(qformer_params, device),
            "ln_vision": to_torch(ln_vision, device)}


def chexpert(params: Dict, state: Dict, device="cuda") -> Tuple[Dict, Dict]:
    """chexpert_classifier_init's (params, state)."""
    return to_torch(params, device), to_torch(state, device)


def chexbert(params: Dict, device="cuda") -> Dict:
    """chexbert_init's tree: {"bert": embeddings + encoder layers, "heads"}."""
    return to_torch(params, device)


def pipeline_weights(pipe, trees: Dict, device="cpu"):
    """A JAX pipeline's weights, as numpy trees under its attribute names
    ("llama", "lora", "blip2", "visual", "visual_state", "classifier",
    "classifier_state", "chexbert"; any subset), set on the port's pipeline
    ``pipe``. The float pipeline's stacked llama tree is kept as it is; a
    serving tree (a list of layers, packed leaves as dicts) goes through
    ``llama_serving``. Returns ``pipe``."""
    for name, tree in trees.items():
        if name == "llama" and isinstance(tree["layers"], (list, tuple)):
            value = llama_serving(tree, pipe.llama_cfg, device)
        else:
            value = to_torch(tree, device)
        setattr(pipe, name, value)
    return pipe
