"""LLaMA decoder (Vicuna-7B) with LoRA on q/v and the image-embedding splice:
the unrolled W8A8 serving path of radialog_tpu/models/llama.py.

Covered: prefill straight into the int8 token-flat cache (attention on the
layer's own compute-dtype K/V, optionally merged with a shared prefix in one
softmax), single-token decode over the cache through the flash-decode
kernel (ops/flash_decode.py, K2) with the static-slot mask and the shared
int8 prefix, and the cache-free prefill that ``prefix_kv`` runs. The
stacked-scan training layout, speculative ``verify``, ``defer_kv`` and
tensor parallelism are not ported yet.

The int8 KV cache is updated IN PLACE (a PyTorch tensor is mutable; the JAX
package returns a new cache from dynamic_update_slice): ``llama_apply``
writes each layer's quantized K/V rows into ``cache`` and returns the same
object.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import NEG_INF, mha, mha_shared_prefix
from ..ops.flash_decode import flash_decode_int8
from ..ops.layers import DTypePolicy, FP32, embedding_lookup, linear, rmsnorm
from ..ops.rotary import apply_rope, rope_tables


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32001
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 11008
    max_position: int = 2048
    rms_eps: float = 1e-6
    rope_theta: float = 10000.0
    img_token_id: int = 32000
    num_img_tokens: int = 32
    qformer_dim: int = 768
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


VICUNA_7B = LlamaConfig()
TINY_LLAMA = LlamaConfig(vocab_size=256, hidden_size=64, num_layers=2,
                         num_heads=4, num_kv_heads=4, intermediate_size=128,
                         max_position=128, img_token_id=250, num_img_tokens=4,
                         qformer_dim=32)


@dataclasses.dataclass
class KVCache:
    """int8 token-flat cache: k/v (L, B, S, H*D) int8, per-token-per-head
    scales k_scale/v_scale (L, B, S, H) bf16. The port stores the scales at
    their H lanes (the JAX package pads them to 128 lanes for XLA's sake)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


@dataclasses.dataclass
class PrefixKV:
    """Compute-dtype K/V of a shared prompt prefix: k/v (L, P0, H, D)."""

    k: torch.Tensor
    v: torch.Tensor


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, device="cuda") -> KVCache:
    """Zeroed int8 cache (scales 1) for ``batch`` lanes of ``max_len`` slots."""
    if cfg.num_kv_heads != cfg.num_heads:
        # the token-flat int8 cache and K2 index K/V by the query head count
        raise NotImplementedError(
            f"int8 KV cache requires num_kv_heads == num_heads "
            f"(got {cfg.num_kv_heads} != {cfg.num_heads})")
    flat = (cfg.num_layers, batch, max_len, cfg.num_kv_heads * cfg.head_dim)
    sc = flat[:3] + (cfg.num_kv_heads,)
    return KVCache(torch.zeros(flat, dtype=torch.int8, device=device),
                   torch.zeros(flat, dtype=torch.int8, device=device),
                   torch.ones(sc, dtype=torch.bfloat16, device=device),
                   torch.ones(sc, dtype=torch.bfloat16, device=device))


def quantize_kv(x: torch.Tensor, scale_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) float -> (int8 (..., D), scale (...)) per-row symmetric.

    The scale is rounded to ``scale_dtype`` first and the quantization
    divides by the rounded value. At f32 scales this is bitwise the
    activation quantizer (ops/q8_matmul.quantize_act) and K2's q
    quantization, as in the JAX package."""
    xf = x.float()
    scale = (torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0).to(scale_dtype)
    x8 = torch.clamp(torch.round(xf / scale.float()[..., None]), -127, 127).to(torch.int8)
    return x8, scale


# --------------------------------------------------------------------- init
def llama_init(gen: torch.Generator, cfg: LlamaConfig, device="cpu",
               dtype=torch.float32) -> Dict:
    """Stacked float params (leading layer axis), as the JAX ``llama_init``
    lays them out; ops/quant.quantize_llama_host packs them for serving."""
    h, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    kvh = cfg.num_kv_heads * cfg.head_dim

    def dense(shape):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (x * shape[-2] ** -0.5).to(dtype)

    layers = {"wq": {"w": dense((L, h, h))}, "wk": {"w": dense((L, h, kvh))},
              "wv": {"w": dense((L, h, kvh))}, "wo": {"w": dense((L, h, h))},
              "gate": {"w": dense((L, h, inter))}, "up": {"w": dense((L, h, inter))},
              "down": {"w": dense((L, inter, h))},
              "input_ln": torch.ones((L, h), device=device, dtype=dtype),
              "post_ln": torch.ones((L, h), device=device, dtype=dtype)}
    embed = torch.randn((cfg.vocab_size, h), generator=gen, device=device) * 0.02
    return {"embed": embed.to(dtype), "layers": layers,
            "final_ln": torch.ones((h,), device=device, dtype=dtype),
            "lm_head": {"w": dense((h, cfg.vocab_size))}}


def lora_init(gen: torch.Generator, cfg: LlamaConfig, device="cuda", rank: int = 8,
              alpha: float = 16.0, targets: Tuple[str, ...] = ("wq", "wv"),
              dtype=torch.float32) -> Dict:
    """LoRA adapters (stacked over layers, B zero) + img_proj_layer."""
    h, L = cfg.hidden_size, cfg.num_layers
    kvh = cfg.num_kv_heads * cfg.head_dim
    out_dims = {"wq": h, "wk": kvh, "wv": kvh, "wo": h}
    layers = {}
    for t in targets:
        a = torch.randn((L, h, rank), generator=gen, device=device) * h ** -0.5
        layers[t] = {"a": a.to(dtype),
                     "b": torch.zeros((L, rank, out_dims[t]), device=device, dtype=dtype)}
    w = torch.randn((cfg.qformer_dim, h), generator=gen, device=device) * cfg.qformer_dim ** -0.5
    return {"layers": layers,
            "img_proj": {"w": w.to(dtype), "b": torch.zeros((h,), device=device, dtype=dtype)},
            "scale": torch.tensor(alpha / rank, dtype=torch.float32, device=device)}


# ------------------------------------------------------------------ forward
def splice_image_embeddings(embeds: torch.Tensor, img_embs: torch.Tensor,
                            img_start: torch.Tensor) -> torch.Tensor:
    """Replace the run of <IMG> embeddings: embeds (B,T,H); img_embs
    (B,n,H); img_start (B,). Rows with img_start < 0 are left as they are.
    The start is clamped so the run fits, as dynamic_update_slice does."""
    b, t, h = embeds.shape
    n = img_embs.shape[1]
    start = torch.clamp(img_start.long(), 0, t - n)
    idx = (start[:, None] + torch.arange(n, device=embeds.device)[None])[..., None].expand(b, n, h)
    spliced = embeds.scatter(1, idx, img_embs.to(embeds.dtype))
    return torch.where((img_start >= 0)[:, None, None], spliced, embeds)


def find_img_start(tokens: torch.Tensor, img_token_id: int) -> torch.Tensor:
    """(B,T) -> (B,) index of the first <IMG> token, -1 if absent."""
    is_img = tokens == img_token_id
    first = torch.argmax(is_img.int(), dim=1)
    return torch.where(is_img.any(dim=1), first, torch.full_like(first, -1))


def _lora_delta(lora_layer: Dict, name: str, x, lora_scale, policy):
    la = lora_layer[name]
    return lora_scale * linear({"w": la["b"]}, linear({"w": la["a"]}, x, policy), policy)


def _attention_block(lp: Dict, lora_layer, lora_scale, cfg: LlamaConfig, x, positions,
                     rope, bias, cache: Optional[KVCache], layer_idx: int, write_pos,
                     policy: DTypePolicy, lengths=None, slot_info=None, shared_layer=None):
    b, t, _ = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    qkv = linear(lp["wqkv"], x, policy)
    q, k, v = torch.split(qkv, [nh * hd, nh * hd, nh * hd], dim=-1)
    if lora_layer is not None:
        if "wq" in lora_layer:
            q = q + _lora_delta(lora_layer, "wq", x, lora_scale, policy).to(q.dtype)
        if "wv" in lora_layer:
            v = v + _lora_delta(lora_layer, "wv", x, lora_scale, policy).to(v.dtype)
    q, k, v = (y.reshape(b, t, nh, hd) for y in (q, k, v))
    cos, sin = rope
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)

    if cache is None:   # cache-free prefill (prefix_kv): return the fresh K/V
        o = mha(q, k, v, bias=bias).reshape(b, t, nh * hd)
        return linear(lp["wo"], o, policy), (k, v)

    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    rows = slice(write_pos, write_pos + t)
    cache.k[layer_idx, :, rows] = k8.reshape(b, t, nh * hd)
    cache.v[layer_idx, :, rows] = v8.reshape(b, t, nh * hd)
    cache.k_scale[layer_idx, :, rows] = ks
    cache.v_scale[layer_idx, :, rows] = vs
    if t > 1:
        # prefill attends this layer's compute-dtype K/V (the int8 rounding
        # only affects decode reads), merged with the compute-dtype prefix
        if shared_layer is not None:
            k0, v0 = shared_layer
            o = mha_shared_prefix(q, k0.to(x.dtype), v0.to(x.dtype), k, v,
                                  bias1=bias[..., :t])
        else:
            o = mha(q, k, v, bias=bias[..., :t])
    else:
        if slot_info is None or lengths is None:
            raise ValueError("single-token decode over the int8 cache needs "
                             "lengths and slot_info (prompt_pad, step)")
        sl, p0 = shared_layer if shared_layer is not None else (None, None)
        prompt_pad, step = slot_info
        o = flash_decode_int8(q[:, 0], cache.k, cache.k_scale, cache.v, cache.v_scale,
                              lengths, prompt_pad, step, layer_idx=layer_idx,
                              scale=hd ** -0.5, shared=sl, p0=p0)[:, None].to(q.dtype)
    o = o.reshape(b, t, nh * hd)
    return linear(lp["wo"], o, policy), cache


def _mlp(lp: Dict, x, policy: DTypePolicy):
    g, u = torch.chunk(linear(lp["gateup"], x, policy), 2, dim=-1)
    return linear(lp["down"], F.silu(g) * u, policy)


def llama_apply(params: Dict, cfg: LlamaConfig, tokens: torch.Tensor,
                positions: torch.Tensor, bias: Optional[torch.Tensor],
                cache: Optional[KVCache] = None, write_pos: int = 0,
                img_embs: Optional[torch.Tensor] = None,
                img_start: Optional[torch.Tensor] = None,
                lora: Optional[Dict] = None, policy: DTypePolicy = FP32,
                lengths: Optional[torch.Tensor] = None, slot_info=None,
                last_pos: Optional[torch.Tensor] = None,
                shared_kv=None, shared_p0: Optional[int] = None):
    """Unrolled serving forward. Returns (logits, cache): logits (B,T,V) or,
    with ``last_pos`` (B,), (B,1,V) f32. With ``cache`` the updated cache
    (the same object, written in place); without, a PrefixKV of the fresh
    per-layer K/V (L,B,T,H,D).

    tokens/positions (B,T); bias (B|1,1,T,T) for a prefill; slot_info =
    (prompt_pad, step) for single-token decode; shared_kv: a PrefixKV for
    a prefill, or per-layer int8 (k0, ks0, v0, vs0) tuples for decode with
    ``shared_p0`` live prefix rows."""
    if not isinstance(params["layers"], (list, tuple)):
        raise ValueError("the port runs the unrolled serving layout "
                         "(ops/quant.quantize_llama_host)")
    x = embedding_lookup(params["embed"], tokens).to(policy.compute)
    lora_scale = lora["scale"] if lora is not None else None
    if img_embs is not None and img_start is not None:
        proj = lora["img_proj"] if (lora is not None and "img_proj" in lora) else params["img_proj"]
        x = splice_image_embeddings(x, linear(proj, img_embs.to(policy.compute), policy),
                                    img_start)
    rope = rope_tables(cfg.head_dim, cfg.max_position, cfg.rope_theta, device=x.device)
    lora_layers = lora["layers"] if lora is not None else None
    fresh_k: List[torch.Tensor] = []
    fresh_v: List[torch.Tensor] = []
    for i, lp in enumerate(params["layers"]):
        ll = ({n: {"a": d["a"][i], "b": d["b"][i]} for n, d in lora_layers.items()}
              if lora_layers is not None else None)
        if shared_kv is None:
            shared_layer = None
        elif isinstance(shared_kv, PrefixKV):
            shared_layer = (shared_kv.k[i], shared_kv.v[i])
        else:
            shared_layer = (tuple(shared_kv[i]), shared_p0)
        h = rmsnorm(lp["input_ln"], x, cfg.rms_eps)
        attn_out, out = _attention_block(lp, ll, lora_scale, cfg, h, positions, rope, bias,
                                         cache, i, write_pos, policy, lengths=lengths,
                                         slot_info=slot_info, shared_layer=shared_layer)
        if cache is None:
            fresh_k.append(out[0])
            fresh_v.append(out[1])
        x = x + attn_out
        h = rmsnorm(lp["post_ln"], x, cfg.rms_eps)
        x = x + _mlp(lp, h, policy)
    logits = _final_logits(params, cfg, x, policy, last_pos)
    if cache is not None:
        return logits, cache
    return logits, PrefixKV(torch.stack(fresh_k), torch.stack(fresh_v))


def _final_logits(params: Dict, cfg: LlamaConfig, x, policy, last_pos):
    x = rmsnorm(params["final_ln"], x, cfg.rms_eps)
    if last_pos is not None:
        x = x[torch.arange(x.shape[0], device=x.device)[:, None], last_pos.long()[:, None]]
    return linear(params["lm_head"], x, policy).float()


# -------------------------------------------------------------- mask helpers
def prefill_bias(lengths: torch.Tensor, t: int, dtype=torch.float32) -> torch.Tensor:
    """(B,1,T,T) causal bias, masking kv >= len."""
    dev = lengths.device
    qi = torch.arange(t, device=dev)[None, :, None]
    kj = torch.arange(t, device=dev)[None, None, :]
    ok = (kj <= qi) & (kj < lengths[:, None, None])
    return torch.where(ok, 0.0, NEG_INF).to(dtype)[:, None]
