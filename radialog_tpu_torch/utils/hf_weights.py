"""Torch / HF checkpoints -> the port's parameter trees (port of
radialog_tpu/utils/hf_weights.py), and the readers of checkpoint files.

The reference loads five checkpoint families: HF ``LlamaForCausalLM``
(Vicuna-7B), PEFT LoRA adapters with the spliced ``img_proj_layer``, HF BERT
(CheXbert), the LAVIS Blip2Qformer ``.pth`` and the BioViL-T / Lightning
classifier ``.ckpt``. Each converter maps a state dict (tensor or numpy
values) onto the tree the port's models read, which is the JAX package's
tree leaf for leaf: torch Linear (out, in) -> {"w": (in, out)}, Conv2d OIHW
-> HWIO, LLaMA layers stacked over depth, BatchNorm running statistics in a
state tree.

A leaf keeps its checkpoint's dtype where the JAX package's f32 copy would
change no value: fp16, bf16 and f32 stay as they are (fp16 -> f32 is exact,
and fp16 -> bf16 rounds as fp16 -> f32 -> bf16 does), so a Vicuna-7B in fp16
is never held in f32 on the host. Other dtypes of a tensor become f32, as
there. The callers cast to the dtype they run in.

``_torch_load`` and ``_load_hf_state_dict`` read the files: ``torch.load``
of a ``.bin``, ``.pth`` or ``.ckpt``, and the safetensors format through a
reader of the port's own (the card's machine has no ``safetensors``
package).
"""
from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_KEPT = (torch.float16, torch.bfloat16, torch.float32)


def _t(x: Any) -> torch.Tensor:
    """A CPU tensor of a state-dict value: fp16 / bf16 / f32 tensors as they
    are, other tensors in f32, numpy arrays in their own dtype."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x if x.dtype in _KEPT else x.float()
    return torch.from_numpy(np.array(x))


def _lin(sd: Dict, name: str, bias: bool = True) -> Dict:
    p = {"w": _t(sd[f"{name}.weight"]).T.contiguous()}
    if bias and f"{name}.bias" in sd:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def _conv(sd: Dict, name: str) -> Dict:
    p = {"w": _t(sd[f"{name}.weight"]).permute(2, 3, 1, 0).contiguous()}   # OIHW -> HWIO
    if f"{name}.bias" in sd:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def _ln(sd: Dict, name: str) -> Dict:
    return {"scale": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"])}


def _bn(sd: Dict, name: str) -> Tuple[Dict, Dict]:
    params = {"scale": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"])}
    count = sd.get(f"{name}.num_batches_tracked", 0)
    state = {"mean": _t(sd[f"{name}.running_mean"]), "var": _t(sd[f"{name}.running_var"]),
             "count": torch.as_tensor(count).float()}
    return params, state


# ---------------------------------------------------------------------- llama
_LLAMA_PROJ = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
               "wo": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
               "down": "mlp.down_proj"}


def llama_layer(sd: Dict, i: int) -> Dict:
    """Layer ``i`` of an HF LlamaForCausalLM state dict as one layer of
    ``llama_init``'s tree, of views of the checkpoint's tensors: each
    (out, in) weight transposed, not copied."""
    pre = f"model.layers.{i}."
    layer = {name: {"w": _t(sd[f"{pre}{key}.weight"]).T} for name, key in _LLAMA_PROJ.items()}
    layer["input_ln"] = _t(sd[f"{pre}input_layernorm.weight"])
    layer["post_ln"] = _t(sd[f"{pre}post_attention_layernorm.weight"])
    return layer


def convert_llama(sd: Dict, num_layers: int, stack: bool = True) -> Dict:
    """HF LlamaForCausalLM state dict -> ``llama_init``'s tree (stacked layers),
    plus ``img_proj`` when the base carries ``model.img_proj_layer``.

    ``stack=False`` leaves ``layers`` a list of ``llama_layer`` views, which
    ``ops/quant.quantize_llama_host``, ``quantize_llama_np`` and
    ``stack_layers`` take one layer at a time: the host then holds the
    checkpoint's bytes once, not a second stacked copy."""
    layers = [llama_layer(sd, i) for i in range(num_layers)]
    if stack:
        layers = {k: ({"w": torch.stack([lay[k]["w"] for lay in layers])}
                      if isinstance(v, dict) else torch.stack([lay[k] for lay in layers]))
                  for k, v in layers[0].items()}
    params = {"embed": _t(sd["model.embed_tokens.weight"]), "layers": layers,
              "final_ln": _t(sd["model.norm.weight"]),
              "lm_head": {"w": _t(sd["lm_head.weight"]).T.contiguous()}}
    if "model.img_proj_layer.weight" in sd:
        params["img_proj"] = _lin(sd, "model.img_proj_layer")
    return params


def stack_layers(layers: List[Dict], device, dtype: torch.dtype) -> Dict:
    """A list of per-layer trees (``convert_llama(stack=False)``) -> the
    stacked tree on ``device`` in ``dtype``, filled one layer at a time, so
    no stacked copy is made on the host."""
    def stack(leaves):
        out = torch.empty((len(leaves), *leaves[0].shape), dtype=dtype, device=device)
        for i, x in enumerate(leaves):
            out[i].copy_(x.to(device))   # the checkpoint's dtype crosses; cast on device
        return out
    return {k: ({kk: stack([lay[k][kk] for lay in layers]) for kk in v}
                if isinstance(v, dict) else stack([lay[k] for lay in layers]))
            for k, v in layers[0].items()}


# both the reference-era key format (lora_A.weight) and PEFT's with the
# adapter name (lora_A.default.weight)
_PEFT_RE = re.compile(
    r"base_model\.model\.model\.layers\.(\d+)\.self_attn\.(\w+)_proj\."
    r"lora_(A|B)(?:\.\w+)?\.weight")


def convert_peft_lora(sd: Dict, num_layers: int, rank: int | None = None,
                      alpha: float | None = None,
                      adapter_config: Dict | None = None) -> Dict:
    """PEFT adapter_model.bin -> ``lora_init``'s tree.

    rank and alpha resolve in order: the arguments, then ``adapter_config``
    (``{"r", "lora_alpha"}`` of the adapter_config.json beside the weights),
    then the reference's r=8, alpha=16. The rank is checked against the
    lora_A shapes: a mismatch, or ranks that differ between targets, raise.
    ``img_proj`` is read under either prefix the reference saves it with."""
    if adapter_config:
        rank = rank if rank is not None else adapter_config.get("r")
        alpha = alpha if alpha is not None else adapter_config.get("lora_alpha")
    per_target: Dict[str, Dict[str, List]] = {}
    for key, val in sd.items():
        m = _PEFT_RE.match(key)
        if not m:
            continue
        i, target, ab = int(m.group(1)), "w" + m.group(2), m.group(3)
        slot = per_target.setdefault(target, {"a": [None] * num_layers,
                                              "b": [None] * num_layers})
        slot["a" if ab == "A" else "b"][i] = _t(val).T   # (in, r) / (r, out)
    layers = {}
    for target, ab in sorted(per_target.items()):
        if any(x is None for x in ab["a"] + ab["b"]):
            raise ValueError(f"missing LoRA layers for target {target}")
        layers[target] = {"a": torch.stack(ab["a"]), "b": torch.stack(ab["b"])}

    loaded_ranks = {t: ab["a"].shape[-1] for t, ab in layers.items()}
    if layers:
        if len(set(loaded_ranks.values())) != 1:
            raise ValueError(f"inconsistent LoRA ranks across targets: {loaded_ranks}")
        loaded_rank = next(iter(loaded_ranks.values()))
        if rank is not None and rank != loaded_rank:
            raise ValueError(f"adapter rank mismatch: config says r={rank} but lora_A "
                             f"shapes give r={loaded_ranks}")
        rank = loaded_rank
    rank = rank if rank is not None else 8
    alpha = alpha if alpha is not None else 16.0

    lora: Dict = {"layers": layers,
                  "scale": torch.tensor(np.float32(alpha / rank))}
    for prefix in ("base_model.model.model.img_proj_layer", "base_model.model.img_proj_layer"):
        if f"{prefix}.weight" in sd:
            lora["img_proj"] = {"w": _t(sd[f"{prefix}.weight"]).T.contiguous(),
                                "b": _t(sd[f"{prefix}.bias"])}
            break
    return lora


# ----------------------------------------------------------------------- bert
def _bert_layer(sd: Dict, q: str) -> Dict:
    return {"attn": {"q": _lin(sd, f"{q}.attention.self.query"),
                     "k": _lin(sd, f"{q}.attention.self.key"),
                     "v": _lin(sd, f"{q}.attention.self.value"),
                     "out": _lin(sd, f"{q}.attention.output.dense"),
                     "out_ln": _ln(sd, f"{q}.attention.output.LayerNorm")},
            "ffn": {"inter": _lin(sd, f"{q}.intermediate.dense"),
                    "out": _lin(sd, f"{q}.output.dense"),
                    "out_ln": _ln(sd, f"{q}.output.LayerNorm")}}


def convert_bert(sd: Dict, num_layers: int, prefix: str = "bert.",
                 with_pooler: bool = False) -> Dict:
    """HF BertModel state dict -> ``bert_init``'s tree."""
    p = prefix
    emb = {"word": _t(sd[f"{p}embeddings.word_embeddings.weight"]),
           "position": _t(sd[f"{p}embeddings.position_embeddings.weight"]),
           "ln": _ln(sd, f"{p}embeddings.LayerNorm")}
    if f"{p}embeddings.token_type_embeddings.weight" in sd:
        emb["token_type"] = _t(sd[f"{p}embeddings.token_type_embeddings.weight"])
    layers = [_bert_layer(sd, f"{p}encoder.layer.{i}") for i in range(num_layers)]
    out = {"embeddings": emb, "encoder": {"layers": layers}}
    if with_pooler and f"{p}pooler.dense.weight" in sd:
        out["pooler"] = _lin(sd, f"{p}pooler.dense")
    return out


def convert_chexbert(sd: Dict, num_layers: int = 12) -> Dict:
    """CheXbert's bert_labeler state dict (bert.* + linear_heads.{i}.*), with
    or without DataParallel's ``module.`` prefix."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return {"bert": convert_bert(sd, num_layers, prefix="bert."),
            "heads": [_lin(sd, f"linear_heads.{i}") for i in range(14)]}


# -------------------------------------------------------------------- qformer
def convert_qformer(sd: Dict, num_layers: int = 12, cross_attention_freq: int = 2,
                    prefix: str = "Qformer.") -> Dict:
    """LAVIS Qformer (BertLMHeadModel) weights -> ``qformer_init``'s tree: image
    cross-attention in every ``cross_attention_freq``-th layer."""
    p = prefix
    layers = []
    for i in range(num_layers):
        q = f"{p}bert.encoder.layer.{i}"
        layer = _bert_layer(sd, q)
        layer["ffn_query"] = {"inter": _lin(sd, f"{q}.intermediate_query.dense"),
                              "out": _lin(sd, f"{q}.output_query.dense"),
                              "out_ln": _ln(sd, f"{q}.output_query.LayerNorm")}
        if i % cross_attention_freq == 0:
            layer["cross"] = {"q": _lin(sd, f"{q}.crossattention.self.query"),
                              "k": _lin(sd, f"{q}.crossattention.self.key"),
                              "v": _lin(sd, f"{q}.crossattention.self.value"),
                              "out": _lin(sd, f"{q}.crossattention.output.dense"),
                              "out_ln": _ln(sd, f"{q}.crossattention.output.LayerNorm")}
        layers.append(layer)
    query = _t(sd["query_tokens"])
    return {
        "embeddings": {"word": _t(sd[f"{p}bert.embeddings.word_embeddings.weight"]),
                       "position": _t(sd[f"{p}bert.embeddings.position_embeddings.weight"]),
                       "ln": _ln(sd, f"{p}bert.embeddings.LayerNorm")},
        "layers": layers,
        "query_tokens": query.reshape(-1, query.shape[-1]),
        "cls": {"transform": _lin(sd, f"{p}cls.predictions.transform.dense"),
                "transform_ln": _ln(sd, f"{p}cls.predictions.transform.LayerNorm"),
                "decoder_bias": _t(sd[f"{p}cls.predictions.bias"])},
    }


def convert_blip2(sd: Dict, num_layers: int = 12,
                  with_vision: bool = True) -> Tuple[Dict, Dict]:
    """A Blip2Qformer checkpoint's ``model`` -> (params, state); the BioViL-T
    encoder under ``visual_encoder.`` when present."""
    params = {"qformer": convert_qformer(sd, num_layers), "ln_vision": _ln(sd, "ln_vision"),
              "vision_proj": _lin(sd, "vision_proj"), "text_proj": _lin(sd, "text_proj"),
              "itm_head": _lin(sd, "itm_head"), "temp": _t(sd["temp"])}
    state: Dict = {}
    if with_vision and "visual_encoder.encoder.encoder.conv1.weight" in sd:
        params["visual"], state["visual"] = convert_biovil_t(sd, prefix="visual_encoder.")
    return params, state


# -------------------------------------------------------------------- biovil-t
def _convert_resnet(sd: Dict, prefix: str,
                    layers: Tuple[int, ...] = (3, 4, 6, 3)) -> Tuple[Dict, Dict]:
    p: Dict = {"conv1": _conv(sd, f"{prefix}conv1")}
    s: Dict = {}
    p["bn1"], s["bn1"] = _bn(sd, f"{prefix}bn1")
    for stage, n_blocks in enumerate(layers, start=1):
        bp_list, bs_list = [], []
        for b in range(n_blocks):
            q = f"{prefix}layer{stage}.{b}"
            bp: Dict = {}
            bs: Dict = {}
            for c in (1, 2, 3):
                if f"{q}.conv{c}.weight" not in sd:
                    break
                bp[f"conv{c}"] = _conv(sd, f"{q}.conv{c}")
                bp[f"bn{c}"], bs[f"bn{c}"] = _bn(sd, f"{q}.bn{c}")
            if f"{q}.downsample.0.weight" in sd:
                bp["down_conv"] = _conv(sd, f"{q}.downsample.0")
                bp["down_bn"], bs["down_bn"] = _bn(sd, f"{q}.downsample.1")
            bp_list.append(bp)
            bs_list.append(bs)
        p[f"layer{stage}"] = bp_list
        s[f"layer{stage}"] = bs_list
    return p, s


def _convert_vit_pooler(sd: Dict, prefix: str, num_blocks: int = 3,
                        grid: Tuple[int, int] = (14, 14)) -> Dict:
    from ..models.vit_pooler import sine_position_embedding
    blocks = []
    for i in range(num_blocks):
        q = f"{prefix}blocks.{i}"
        blocks.append({"norm1": _ln(sd, f"{q}.norm1"), "q": _lin(sd, f"{q}.attn.proj_q"),
                       "k": _lin(sd, f"{q}.attn.proj_k"), "v": _lin(sd, f"{q}.attn.proj_v"),
                       "proj": _lin(sd, f"{q}.attn.proj"), "norm2": _ln(sd, f"{q}.norm2"),
                       "fc1": _lin(sd, f"{q}.mlp.fc1"), "fc2": _lin(sd, f"{q}.mlp.fc2")})
    type_embed = _t(sd[f"{prefix}type_embed"])   # (2, 1, C)
    dim = type_embed.shape[-1]
    return {"blocks": blocks, "norm_post": _ln(sd, f"{prefix}norm_post"),
            "type_embed": type_embed.reshape(2, dim),
            "_pos": sine_position_embedding(grid, dim // 2)}


def convert_biovil_t(sd: Dict, prefix: str = "",
                     layers: Tuple[int, ...] = (3, 4, 6, 3)) -> Tuple[Dict, Dict]:
    """BioViL-T ImageModel state dict -> ``biovil_t_init``'s (params, state).
    ``prefix``: "" for a bare ImageModel, "visual_encoder." inside a BLIP-2
    checkpoint, "model.biovil_encoder." inside the Lightning classifier."""
    p = prefix
    params: Dict = {}
    state: Dict = {}
    params["resnet"], state["resnet"] = _convert_resnet(sd, f"{p}encoder.encoder.", layers)
    params["backbone_to_vit"] = _conv(sd, f"{p}encoder.backbone_to_vit")
    params["vit_pooler"] = _convert_vit_pooler(sd, f"{p}encoder.vit_pooler.")
    params["missing_previous_emb"] = _t(sd[f"{p}encoder.missing_previous_emb"]).reshape(-1)
    params["proj1"] = _conv(sd, f"{p}projector.model.0")
    params["proj_bn"], state["proj_bn"] = _bn(sd, f"{p}projector.model.1")
    params["proj2"] = _conv(sd, f"{p}projector.model.3")
    return params, state


def convert_chexpert_classifier(sd: Dict) -> Tuple[Dict, Dict]:
    """The Lightning classifier's ``state_dict`` (model.biovil_encoder, fc1,
    fc2) -> the classifier's (params, state)."""
    params: Dict = {}
    params["biovil"], biovil_state = convert_biovil_t(sd, prefix="model.biovil_encoder.")
    params["fc1"] = _lin(sd, "model.fc1")
    params["fc2"] = _lin(sd, "model.fc2")
    return params, {"biovil": biovil_state}


# ------------------------------------------------------------------ file readers
def _torch_load(path) -> Any:
    """``torch.load`` on the CPU with ``weights_only=False``: a Lightning
    ``.ckpt`` or a LAVIS ``.pth`` holds entries that are no tensors, which
    torch >= 2.6 refuses by default. Unpickling runs code the file names,
    so the file must come from a source you trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def load_safetensors(path) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor}: an 8-byte little-endian
    header length, a JSON header of {name: {dtype, shape, data_offsets}},
    then the tensors' raw little-endian bytes (this reader assumes a
    little-endian host). Each tensor is read once into its own buffer."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        for name, info in header.items():
            dtype = _ST_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, "
                                 f"which this reader does not take")
            begin, end = info["data_offsets"]
            raw = bytearray(end - begin)
            f.seek(8 + n + begin)
            if f.readinto(raw) != len(raw):
                raise ValueError(f"{path}: tensor {name} ends past the end of the file")
            flat = torch.frombuffer(raw, dtype=torch.uint8) if raw else \
                torch.empty(0, dtype=torch.uint8)
            out[name] = flat.view(dtype).reshape(info["shape"])
    return out


def _load_hf_state_dict(path) -> Dict:
    """An HF checkpoint directory -> one state dict: every ``*.safetensors``
    shard in sorted order, else every ``pytorch_model*.bin`` shard."""
    p = Path(path)
    sd: Dict = {}
    st_files = sorted(p.glob("*.safetensors"))
    if st_files:
        for f in st_files:
            sd.update(load_safetensors(f))
        return sd
    bins = sorted(p.glob("pytorch_model*.bin"))
    if not bins:
        raise FileNotFoundError(f"no model weights found under {path}")
    for f in bins:
        sd.update(_torch_load(str(f)))
    return sd
