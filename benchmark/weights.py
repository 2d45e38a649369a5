"""Weights and images made from the seed, on the device, in the parameter
layout the port's entry points take (plain dicts of tensors).

Both the program and the plain reference read these tensors, so this file
imports nothing of the program. Each group of weights has a generator of
its own, seeded from (seed, group), so the reference can make one group
again after the program's state is freed. A group is drawn in a few large
calls: one draw per stacked LLaMA leaf, one flat draw carved into the
leaves of a vision tree.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

GROUPS = {"llama": 1, "lora": 2, "vision": 3, "qformer": 4, "classifier": 5, "images": 6}


def generator(seed: int, group: str, device, extra: int = 0) -> torch.Generator:
    """A generator on ``device`` for one group of draws of run ``seed``."""
    mixed = (int(seed) * 1_000_003 + GROUPS[group] * 7_919 + int(extra) * 104_729) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


# ----------------------------------------------------------------- LLaMA
def llama_weights(model: Dict, vocab: int, seed: int, device,
                  dtype=torch.bfloat16) -> Dict:
    """The stacked LLaMA tree (``models/llama.py llama_init``'s layout):
    projections N(0, 1/K), norm gains 1 + 0.1 N(0, 1), the embedding
    0.02 N(0, 1), with ``vocab`` rows (the source's vocabulary and the
    added <IMG> row)."""
    g = generator(seed, "llama", device)
    h, inter = model["hidden_size"], model["intermediate_size"]
    n_layers = model["num_hidden_layers"]
    kvh = model["num_key_value_heads"] * (h // model["num_attention_heads"])

    def dense(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(shape[-2] ** -0.5)

    def gain(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(0.1).add_(1.0)

    layers = {"wq": {"w": dense(n_layers, h, h)}, "wk": {"w": dense(n_layers, h, kvh)},
              "wv": {"w": dense(n_layers, h, kvh)}, "wo": {"w": dense(n_layers, h, h)},
              "gate": {"w": dense(n_layers, h, inter)}, "up": {"w": dense(n_layers, h, inter)},
              "down": {"w": dense(n_layers, inter, h)},
              "input_ln": gain(n_layers, h), "post_ln": gain(n_layers, h)}
    embed = torch.randn((vocab, h), generator=g, device=device, dtype=dtype).mul_(0.02)
    return {"embed": embed, "layers": layers, "final_ln": gain(h),
            "lm_head": {"w": dense(h, vocab)}}


def lora_weights(model: Dict, lora: Dict, qformer_dim: int, seed: int, device,
                 dtype=torch.bfloat16) -> Dict:
    """LoRA on ``lora["targets"]`` with both factors drawn (B is not zero,
    so the delta is live) and the image projection (``lora_init``'s
    layout)."""
    g = generator(seed, "lora", device)
    h, n_layers, r = model["hidden_size"], model["num_hidden_layers"], lora["rank"]
    kvh = model["num_key_value_heads"] * (h // model["num_attention_heads"])
    out_dims = {"wq": h, "wk": kvh, "wv": kvh, "wo": h}
    layers = {}
    for t in lora["targets"]:
        a = torch.randn((n_layers, h, r), generator=g, device=device) * h ** -0.5
        b = torch.randn((n_layers, r, out_dims[t]), generator=g, device=device) * (0.1 * r ** -0.5)
        layers[t] = {"a": a.to(dtype), "b": b.to(dtype)}
    w = torch.randn((qformer_dim, h), generator=g, device=device) * qformer_dim ** -0.5
    b = torch.randn((h,), generator=g, device=device) * 0.02
    return {"layers": layers, "img_proj": {"w": w.to(dtype), "b": b.to(dtype)},
            "scale": torch.tensor(lora["alpha"] / r, dtype=torch.float32, device=device)}


# ---------------------------------------------------------- vision trees
class _Spec:
    """Leaves of a tree to carve from one flat standard-normal draw: each
    (path, shape, kind); ``kind`` maps a draw z to the leaf's values."""

    def __init__(self):
        self.leaves: List[Tuple[Tuple, Tuple[int, ...], str]] = []

    def add(self, path: Tuple, shape: Sequence[int], kind: str) -> None:
        self.leaves.append((path, tuple(shape), kind))

    def build(self, g: torch.Generator, device) -> Dict:
        total = sum(math.prod(s) for _, s, _ in self.leaves)
        flat = torch.randn((total,), generator=g, device=device, dtype=torch.float32)
        tree: Dict = {}
        at = 0
        for path, shape, kind in self.leaves:
            n = math.prod(shape)
            z = flat[at:at + n].reshape(shape)
            at += n
            _put(tree, path, _value(z, shape, kind))
        return tree


def _value(z: torch.Tensor, shape, kind: str) -> torch.Tensor:
    if kind == "conv":            # kaiming normal over the fan-in (kh, kw, Cin, Cout)
        return z * math.sqrt(2.0 / math.prod(shape[:-1]))
    if kind == "lin":             # (in, out)
        return z * shape[0] ** -0.5
    if kind == "small":           # biases, embeddings, running means, beta
        return z * 0.02
    if kind == "gain":            # norm and batch-norm gains
        return 1.0 + 0.1 * z
    if kind == "res_gain":        # the last batch norm of a residual branch
        return 0.3 + 0.05 * z
    if kind == "var":             # batch-norm running variances, positive
        return 0.75 + 0.25 * torch.tanh(z)
    if kind == "zero":
        return torch.zeros_like(z)
    raise ValueError(kind)


def _put(tree: Dict, path: Tuple, value) -> None:
    node = tree
    for i, key in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
            continue
        if key not in node:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append({})
        node[path[-1]] = value
    else:
        node[path[-1]] = value


def _bn(spec_p: _Spec, spec_s: _Spec, path: Tuple, ch: int, gain: str = "gain") -> None:
    spec_p.add(path + ("scale",), (ch,), gain)
    spec_p.add(path + ("bias",), (ch,), "small")
    spec_s.add(path + ("mean",), (ch,), "small")
    spec_s.add(path + ("var",), (ch,), "var")
    spec_s.add(path + ("count",), (), "zero")


def _biovil_specs(joint: int, resnet_layers: Sequence[int], prefix: Tuple = ()):
    """BioViL-T's trunk (ResNet-50 bottlenecks), its 1x1 projector and the
    missing-prior embedding (``models/biovil_t.py biovil_t_init``'s layout;
    the ViT pooler, which runs only with a prior image, is left out)."""
    p, s = _Spec(), _Spec()
    r = prefix + ("resnet",)
    p.add(r + ("conv1", "w"), (7, 7, 3, 64), "conv")
    _bn(p, s, r + ("bn1",), 64)
    in_ch = 64
    for stage, n_blocks in enumerate(resnet_layers):
        width = 64 * 2 ** stage
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            blk = r + (f"layer{stage + 1}", b)
            p.add(blk + ("conv1", "w"), (1, 1, in_ch, width), "conv")
            _bn(p, s, blk + ("bn1",), width)
            p.add(blk + ("conv2", "w"), (3, 3, width, width), "conv")
            _bn(p, s, blk + ("bn2",), width)
            p.add(blk + ("conv3", "w"), (1, 1, width, 4 * width), "conv")
            _bn(p, s, blk + ("bn3",), 4 * width, "res_gain")
            if stride != 1 or in_ch != 4 * width:
                p.add(blk + ("down_conv", "w"), (1, 1, in_ch, 4 * width), "conv")
                _bn(p, s, blk + ("down_bn",), 4 * width, "res_gain")
            in_ch = 4 * width
    p.add(prefix + ("backbone_to_vit", "w"), (1, 1, in_ch, 256), "conv")
    p.add(prefix + ("missing_previous_emb",), (256,), "small")
    p.add(prefix + ("proj1", "w"), (1, 1, 512, joint), "conv")
    _bn(p, s, prefix + ("proj_bn",), joint)
    p.add(prefix + ("proj2", "w"), (1, 1, joint, joint), "conv")
    p.add(prefix + ("proj2", "b"), (joint,), "small")
    return p, s


def vision_weights(vision: Dict, seed: int, device) -> Tuple[Dict, Dict]:
    """(params, state) of the report's BioViL-T at the Q-Former's encoder
    width, f32."""
    p, s = _biovil_specs(vision["encoder_width"], vision["resnet_layers"])
    g = generator(seed, "vision", device)
    return p.build(g, device), s.build(g, device)


def classifier_weights(vision: Dict, seed: int, device) -> Tuple[Dict, Dict]:
    """(params, state) of the CheXpert findings classifier (its own
    BioViL-T at joint width 128, then fc1 and fc2; ``models/chexpert.py``'s
    layout), f32."""
    p, s = _biovil_specs(128, vision["resnet_layers"], ("biovil",))
    grid = vision["classifier_pool_grid"]
    p.add(("fc1", "w"), (128 * grid * grid, 512), "lin")
    p.add(("fc1", "b"), (512,), "small")
    p.add(("fc2", "w"), (512, vision["num_classes"]), "lin")
    p.add(("fc2", "b"), (vision["num_classes"],), "small")
    g = generator(seed, "classifier", device)
    return p.build(g, device), s.build(g, device)


def qformer_weights(vision: Dict, seed: int, device) -> Dict:
    """{"qformer", "ln_vision"}: the leaves the image-grounded Q-Former
    pass reads (``models/qformer.py qformer_init``'s layout: the text
    branch, which that pass never reads, is left out), f32."""
    q = vision["qformer"]
    hid, inter, enc = q["hidden_size"], q["intermediate_size"], vision["encoder_width"]
    p = _Spec()
    p.add(("ln_vision", "scale"), (enc,), "gain")
    p.add(("ln_vision", "bias"), (enc,), "small")
    qf = ("qformer",)
    p.add(qf + ("embeddings", "ln", "scale"), (hid,), "gain")
    p.add(qf + ("embeddings", "ln", "bias"), (hid,), "small")
    p.add(qf + ("query_tokens",), (vision["num_query_tokens"], hid), "small")
    for i in range(q["num_layers"]):
        lay = qf + ("layers", i)
        blocks = [("attn", hid)] + ([("cross", enc)] if i % q["cross_attention_freq"] == 0 else [])
        for name, kv in blocks:
            for leaf, k_in in (("q", hid), ("k", kv), ("v", kv), ("out", hid)):
                p.add(lay + (name, leaf, "w"), (k_in, hid), "lin")
                p.add(lay + (name, leaf, "b"), (hid,), "small")
            p.add(lay + (name, "out_ln", "scale"), (hid,), "gain")
            p.add(lay + (name, "out_ln", "bias"), (hid,), "small")
        ffn = lay + ("ffn_query",)
        p.add(ffn + ("inter", "w"), (hid, inter), "lin")
        p.add(ffn + ("inter", "b"), (inter,), "small")
        p.add(ffn + ("out", "w"), (inter, hid), "lin")
        p.add(ffn + ("out", "b"), (hid,), "small")
        p.add(ffn + ("out_ln", "scale"), (hid,), "gain")
        p.add(ffn + ("out_ln", "bias"), (hid,), "small")
    return p.build(generator(seed, "qformer", device), device)


# ---------------------------------------------------------------- images
def images_u8(seed: int, index: int, count: int, px: int, device) -> torch.Tensor:
    """``count`` grey-level studies (count, px, px) uint8 of batch
    ``index``: smooth structure (a coarse random field upsampled) plus
    pixel noise, so the convolutions see more than white noise."""
    g = generator(seed, "images", device, extra=index)
    coarse = torch.rand((count, 1, 16, 16), generator=g, device=device)
    field = torch.nn.functional.interpolate(coarse, size=(px, px), mode="bilinear",
                                            align_corners=False)[:, 0]
    noise = torch.rand((count, px, px), generator=g, device=device)
    return (255.0 * (0.8 * field + 0.2 * noise)).round_().clamp_(0, 255).to(torch.uint8)


def crop_float(u8: torch.Tensor, size: int) -> torch.Tensor:
    """The centre ``size`` x ``size`` crop of (B, S, S) uint8 as (B, size,
    size, 3) float in [0, 1], the grey level in every channel."""
    s = u8.shape[-1]
    top = (s - size) // 2
    x = u8[:, top:top + size, top:top + size].float() / 255.0
    return x[..., None].expand(-1, -1, -1, 3).contiguous()
