"""LLaMA decoder (Vicuna-7B) with LoRA on q/v and the image-embedding splice:
the unrolled W8A8 serving path and the stacked training layout of
radialog_tpu/models/llama.py.

Covered: prefill straight into the int8 token-flat cache (attention on the
layer's own compute-dtype K/V, optionally merged with a shared prefix in one
softmax), single-token decode over the cache through the flash-decode
kernel (ops/flash_decode.py, K2) with the static-slot mask and the shared
int8 prefix or with the ring batcher's per-lane slot intervals, and with
``defer_kv`` the same decode with in-kernel cache writes (K2''), the
cache-free prefill that ``prefix_kv``, the engine's small-batch ``prefill``
and the ring batcher's admission run, whose attention at 256 tokens or more
is the flash-attention kernel (ops/flash_attention.py, K3), and the bf16
cache of the batch engine and of the ring batcher (direct prefill, and
decode as ``mha`` over the layer's cache rows with the caller's bias,
merged with a shared prefix in one softmax where the engine shares one).
Layer projections are W8A8 (K1) or W4A8 (K4) leaves.

The stacked layout (``llama_init``'s tree, float or with the
``{"w_q", "scale"}`` leaves of ops/quant.quantize_llama): ``params["layers"]``
is a dict of leaves with a leading layer axis and separate wq/wk/wv/gate/up;
a layer's weights are the views ``leaf[i]`` (no copy and no scan), LoRA
deltas go through ``_proj``, and ``remat`` recomputes each layer in the
backward pass (``torch.utils.checkpoint``). Without a cache it is the
training forward and the float path's prefill: with ``flash`` its attention
at 256 tokens or more is K3 forward and, under autograd, K5a/K5b backward.
With the bf16 cache it is the JAX package's scan decode of the float
serving path: each layer writes its K/V rows into ``cache.k[i]`` /
``cache.v[i]`` at ``write_pos`` (a scalar, one slot range for every lane,
or a (B,) vector, rows ``write_pos[b] + arange(t)`` of each lane in one
indexed write), then attends the whole layer cache, cast to the compute
dtype, under the caller's bias, for any t (``mha``; no kernel). The int8
cache and a shared prefix need the unrolled serving params and raise.
Speculative ``verify`` and tensor parallelism are not ported yet.

The KV cache is updated IN PLACE (a PyTorch tensor is mutable; the JAX
package returns a new cache from dynamic_update_slice): ``llama_apply``
writes each layer's quantized K/V rows into ``cache`` and returns the same
object.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import NEG_INF, mha, mha_shared_prefix
from ..ops.flash_attention import flash_attention
from ..ops.flash_decode import flash_decode_int8
from ..ops.layers import DTypePolicy, FP32, embedding_lookup, linear, rmsnorm
from ..ops.q8_matmul import div127
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
    their H lanes (the JAX package pads them to 128 lanes for XLA's sake).
    Without scales: the bf16 cache, k/v (L, B, S, H, D)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


@dataclasses.dataclass
class PrefixKV:
    """Compute-dtype K/V of a shared prompt prefix: k/v (L, P0, H, D)."""

    k: torch.Tensor
    v: torch.Tensor


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, device="cuda",
               dtype=torch.bfloat16, quantized: bool = True) -> KVCache:
    """Zeroed cache for ``batch`` lanes of ``max_len`` slots: int8 with
    scales 1, or with ``quantized=False`` the (L, B, S, H, D) cache in
    ``dtype``. The default is the reverse of the JAX package's
    ``init_cache`` (``quantized=False`` there): the port's serving default is
    the int8 cache, and ``kv_int8=False`` of the batch engine
    (decode/engine.py), the pipeline and the ring batcher asks for the other
    one."""
    if not quantized:
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))
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
    scale = div127(torch.clamp(xf.abs().amax(dim=-1), min=1e-8)).to(scale_dtype)
    x8 = torch.clamp(torch.round(xf / scale.float()[..., None]), -127, 127).to(torch.int8)
    return x8, scale


# --------------------------------------------------------------------- init
def llama_init(gen: torch.Generator, cfg: LlamaConfig, device="cuda",
               dtype=torch.float32) -> Dict:
    """Stacked float params (leading layer axis), as the JAX ``llama_init``
    lays them out; ops/quant.quantize_llama_host packs them for serving."""
    h, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    kvh = cfg.num_kv_heads * cfg.head_dim

    def dense(shape):   # one f32 transient a leaf, scaled in place
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(shape[-2] ** -0.5).to(dtype)

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


def _proj(lp: Dict, lora_layer, name: str, x, lora_scale, policy):
    y = linear(lp[name], x, policy)
    if lora_layer is not None and name in lora_layer:
        y = y + _lora_delta(lora_layer, name, x, lora_scale, policy).to(y.dtype)
    return y


def qkv_proj(lp: Dict, lora_layer, lora_scale, cfg: LlamaConfig, x, policy):
    """One layer's Q/K/V in either weight layout: the fused "wqkv" matmul
    of the serving params with the LoRA deltas added to its slices, or the
    separate wq/wk/wv of the stacked training layout. Returns head-split
    (B,T,nh,hd), (B,T,nkv,hd), (B,T,nkv,hd), before RoPE."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "wqkv" in lp:
        q, k, v = torch.split(linear(lp["wqkv"], x, policy), [nh * hd, nkv * hd, nkv * hd],
                              dim=-1)
        if lora_layer is not None:
            q, k, v = (y + _lora_delta(lora_layer, name, x, lora_scale, policy).to(y.dtype)
                       if name in lora_layer else y
                       for name, y in (("wq", q), ("wk", k), ("wv", v)))
    else:
        q, k, v = (_proj(lp, lora_layer, name, x, lora_scale, policy)
                   for name in ("wq", "wk", "wv"))
    return q.reshape(b, t, nh, hd), k.reshape(b, t, nkv, hd), v.reshape(b, t, nkv, hd)


def _use_flash(lengths, t: int, flash: bool = True) -> bool:
    """Flash attention (K3, and K5a/K5b under autograd) for a cache-free
    forward (the only caller) of 256 tokens or more with lengths given,
    unless the caller passes ``flash=False``; on any device (the kernels on a
    card, their plain versions on the CPU). The JAX package also asks for a
    TPU backend; that test is of its hardware, not of the function."""
    return flash and lengths is not None and t >= 256


def _gqa(x, nh: int, axis: int):
    """Repeat the K/V heads on ``axis`` up to the query head count."""
    rep = nh // x.shape[axis]
    return x if rep == 1 else x.repeat_interleave(rep, dim=axis)


def _write_rows(cache: KVCache, layer_idx: int, write_pos, k, v) -> None:
    """Store (B,T,H,D) K/V into layer ``layer_idx`` of the bf16 cache: at
    slots [write_pos, write_pos + T) of every lane for a scalar, or at rows
    write_pos[b] + arange(T) of lane b for a (B,) tensor, in one indexed
    write with no read of the positions on the host."""
    ck, cv = cache.k[layer_idx], cache.v[layer_idx]
    if torch.is_tensor(write_pos) and write_pos.ndim == 1:
        b, t = k.shape[:2]
        bi = torch.arange(b, device=ck.device)[:, None]
        ti = write_pos.to(ck.device).long()[:, None] + torch.arange(t, device=ck.device)[None]
        ck[bi, ti] = k.to(ck.dtype)
        cv[bi, ti] = v.to(cv.dtype)
    else:
        rows = slice(int(write_pos), int(write_pos) + k.shape[1])
        ck[:, rows] = k.to(ck.dtype)
        cv[:, rows] = v.to(cv.dtype)


def _attention_block(lp: Dict, lora_layer, lora_scale, cfg: LlamaConfig, x, positions,
                     rope, bias, cache: Optional[KVCache], layer_idx: int, write_pos,
                     policy: DTypePolicy, lengths=None, slot_info=None, shared_layer=None,
                     flash: bool = True, defer: bool = False, stacked: bool = False):
    b, t, _ = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    q, k, v = qkv_proj(lp, lora_layer, lora_scale, cfg, x, policy)
    cos, sin = rope
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)

    if cache is None:   # cache-free prefill or training forward: return the fresh K/V
        k_all, v_all = _gqa(k, nh, 2), _gqa(v, nh, 2)
        if _use_flash(lengths, t, flash):
            o = flash_attention(q, k_all, v_all, lengths, causal=True)
        else:
            o = mha(q, k_all, v_all, bias=bias)
        return _proj(lp, lora_layer, "wo", o.reshape(b, t, nh * hd), lora_scale, policy), (k, v)

    if stacked:
        # the scan decode: the whole layer cache after the write, the fresh
        # rows read back rounded to the cache's dtype, for any t
        _write_rows(cache, layer_idx, write_pos, k, v)
        k_all = _gqa(cache.k[layer_idx].to(x.dtype), nh, 2)
        v_all = _gqa(cache.v[layer_idx].to(x.dtype), nh, 2)
        o = mha(q, k_all, v_all, bias=bias)
        return _proj(lp, lora_layer, "wo", o.reshape(b, t, nh * hd), lora_scale, policy), cache

    rows = slice(write_pos, write_pos + t)
    if not cache.quantized:
        cache.k[layer_idx, :, rows] = k.to(cache.k.dtype)
        cache.v[layer_idx, :, rows] = v.to(cache.v.dtype)
        if t > 1:   # direct prefill: this layer's own compute-dtype K/V
            k_all, v_all, bias = k, v, bias[..., :t]
        else:       # decode over the layer's cache rows, masked by the caller's bias
            k_all, v_all = cache.k[layer_idx].to(x.dtype), cache.v[layer_idx].to(x.dtype)
        k_all, v_all = _gqa(k_all, nh, 2), _gqa(v_all, nh, 2)
        if shared_layer is not None:
            # (k0, v0) (P0, H, D): the compute-dtype prefix for a prefill, the
            # cache-dtype copy for decode (decode/engine.py), in one softmax
            k0, v0 = (_gqa(z.to(x.dtype), nh, 1) for z in shared_layer)
            o = mha_shared_prefix(q, k0, v0, k_all, v_all, bias1=bias)
        else:
            o = mha(q, k_all, v_all, bias=bias)
        return _proj(lp, lora_layer, "wo", o.reshape(b, t, nh * hd), lora_scale,
                     policy), cache

    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    if not defer:   # with defer the kernel writes the row (below)
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
            raise ValueError("single-token decode over the int8 cache needs lengths "
                             "and slot_info: (prompt_pad, step) or (a1, b1, a2, b2)")
        sl, p0 = shared_layer if shared_layer is not None else (None, None)
        if len(slot_info) == 4:   # the ring batcher's per-lane closed intervals
            mask = dict(gen_intervals=slot_info)
        elif defer:
            # in-kernel cache write (K2''): the step's own row goes to the
            # kernel as an operand, the mask ends at step - 1, and the kernel
            # stores the row at slot prompt_pad + step of this layer
            mask = dict(prompt_pad=slot_info[0], step=slot_info[1] - 1, write_cache=True,
                        current=(k8.reshape(b, 1, nh * hd), ks, v8.reshape(b, 1, nh * hd), vs))
        else:
            mask = dict(prompt_pad=slot_info[0], step=slot_info[1])
        o = flash_decode_int8(q[:, 0], cache.k, cache.k_scale, cache.v, cache.v_scale,
                              lengths, layer_idx=layer_idx, scale=hd ** -0.5, shared=sl,
                              p0=p0, **mask)
        o = (o[0] if defer else o)[:, None].to(q.dtype)
    o = o.reshape(b, t, nh * hd)
    return _proj(lp, lora_layer, "wo", o, lora_scale, policy), cache


def _mlp(lp: Dict, x, policy: DTypePolicy):
    if "gateup" in lp:   # fused serving layout
        g, u = torch.chunk(linear(lp["gateup"], x, policy), 2, dim=-1)
    else:
        g, u = linear(lp["gate"], x, policy), linear(lp["up"], x, policy)
    return linear(lp["down"], F.silu(g) * u, policy)


def _layer_view(layers: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked tree: every leaf indexed on its leading
    layer axis (views, no copy)."""
    return {name: ({k: v[i] for k, v in leaf.items()} if isinstance(leaf, dict) else leaf[i])
            for name, leaf in layers.items()}


def llama_apply(params: Dict, cfg: LlamaConfig, tokens: torch.Tensor,
                positions: torch.Tensor, bias: Optional[torch.Tensor],
                cache: Optional[KVCache] = None, write_pos: Union[int, torch.Tensor] = 0,
                img_embs: Optional[torch.Tensor] = None,
                img_start: Optional[torch.Tensor] = None,
                lora: Optional[Dict] = None, policy: DTypePolicy = FP32,
                lengths: Optional[torch.Tensor] = None, slot_info=None,
                last_pos: Optional[torch.Tensor] = None,
                shared_kv=None, shared_p0: Optional[int] = None,
                remat: bool = False, flash: bool = True,
                defer_kv: Optional[bool] = None):
    """The forward, over the unrolled serving layout (``params["layers"]`` a
    list) or the stacked layout (a dict of leaves with a leading layer axis;
    no cache, or the bf16 cache). Returns (logits, cache): logits (B,T,V) or,
    with ``last_pos`` (B,), (B,1,V) f32. With ``cache`` the updated cache
    (the same object, written in place); without, a PrefixKV of the fresh
    per-layer K/V (L,B,T,H,D).

    ``flash=False`` keeps attention on ``mha`` where flash attention would
    apply. ``remat`` recomputes each layer in the backward pass instead of
    keeping its activations; a forward that records gradients with ``remat``
    returns None in place of the fresh K/V (a training step reads only the
    logits, and keeping them would hold every layer's K and V alive).

    tokens/positions (B,T); bias (B|1,1,T,T) for a prefill, (B|1,1,T,S)
    for a forward over the bf16 cache; ``write_pos`` the first cache slot
    written (the ring slot for the ring batcher), on the stacked layout also
    a (B,) tensor of each lane's first slot; slot_info =
    (prompt_pad, step) for single-token decode over the int8 cache, or the
    ring batcher's per-lane closed slot intervals (a1, b1, a2, b2), each (B,)
    int32 with an empty interval marked b = -1; shared_kv: a PrefixKV for
    a prefill, or per layer for decode int8 (k0, ks0, v0, vs0) tuples with
    ``shared_p0`` live prefix rows or bf16 (k0, v0) pairs.

    ``defer_kv``: True sends a single-token step over the int8 cache with the
    static-slot mask (slot_info of length 2, lengths given) through in-kernel
    cache writes (K2''): each layer hands its quantized K/V row to the
    flash-decode kernel, which attends it and writes it at slot
    prompt_pad + step in place of the four row copies. None reads
    RADIALOG_DEFER_KV ("1" is on), default off, as in the JAX package. As
    there, the write slot comes from slot_info, so ``write_pos`` must equal
    prompt_pad + step; anything else raises. Other calls ignore it."""
    stacked = not isinstance(params["layers"], (list, tuple))
    if stacked and shared_kv is not None:
        raise ValueError("shared_kv (prefix sharing) is a serving feature of the unrolled "
                         "weight layout; the stacked layout has no per-layer merge point")
    if stacked and cache is not None and cache.quantized:
        raise ValueError("int8 KV caches require the unrolled serving params "
                         "(ops/quant.quantize_llama_host layout with a list of layers)")
    num_layers = cfg.num_layers if stacked else len(params["layers"])
    if defer_kv is None:
        defer_kv = os.environ.get("RADIALOG_DEFER_KV", "0") == "1"
    defer_kv = bool(defer_kv and cache is not None and cache.quantized
                    and tokens.shape[1] == 1 and slot_info is not None
                    and len(slot_info) == 2 and lengths is not None)
    if defer_kv and int(write_pos) != int(slot_info[0]) + int(slot_info[1]):
        raise ValueError(f"defer_kv writes at slot prompt_pad + step = "
                         f"{int(slot_info[0]) + int(slot_info[1])}, not write_pos {write_pos}")
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
    remat = remat and torch.is_grad_enabled()
    keep_kv = cache is None and not remat

    def layer_fn(x, i):
        lp = _layer_view(params["layers"], i) if stacked else params["layers"][i]
        ll = _layer_view(lora_layers, i) if lora_layers is not None else None
        if shared_kv is None:
            shared_layer = None
        elif isinstance(shared_kv, PrefixKV):
            shared_layer = (shared_kv.k[i], shared_kv.v[i])
        elif len(shared_kv[i]) == 2:        # the bf16 cache's decode prefix (k0, v0)
            shared_layer = tuple(shared_kv[i])
        else:
            shared_layer = (tuple(shared_kv[i]), shared_p0)
        h = rmsnorm(lp["input_ln"], x, cfg.rms_eps)
        attn_out, out = _attention_block(lp, ll, lora_scale, cfg, h, positions, rope, bias,
                                         cache, i, write_pos, policy, lengths=lengths,
                                         slot_info=slot_info, shared_layer=shared_layer,
                                         flash=flash, defer=defer_kv, stacked=stacked)
        if keep_kv:
            fresh_k.append(out[0])
            fresh_v.append(out[1])
        x = x + attn_out
        h = rmsnorm(lp["post_ln"], x, cfg.rms_eps)
        return x + _mlp(lp, h, policy)

    for i in range(num_layers):
        if remat:   # no dropout in the layer: no RNG state to preserve
            x = checkpoint(layer_fn, x, i, use_reentrant=False, preserve_rng_state=False)
        else:
            x = layer_fn(x, i)
    logits = _final_logits(params, cfg, x, policy, last_pos)
    if cache is not None:
        return logits, cache
    return logits, (PrefixKV(torch.stack(fresh_k), torch.stack(fresh_v)) if keep_kv else None)


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


def decode_bias(kv_valid_len: torch.Tensor, s_max: int, dtype=torch.float32) -> torch.Tensor:
    """(B,1,1,S) bias for single-token decode: attend kv j < kv_valid_len."""
    kj = torch.arange(s_max, device=kv_valid_len.device)[None, :]
    return torch.where(kj < kv_valid_len[:, None], 0.0, NEG_INF).to(dtype)[:, None, None, :]


def decode_bias_static_slot(lengths: torch.Tensor, prompt_pad: int, step: int, s_max: int,
                            dtype=torch.float32) -> torch.Tensor:
    """(B,1,1,S) bias for static-slot decode over the bf16 cache: kv j is
    live where j < lengths[b] (the prompt) or prompt_pad <= j <= prompt_pad
    + step (the generated rows); the pad gap between them is masked."""
    kj = torch.arange(s_max, device=lengths.device)[None, :]
    ok = (kj < lengths[:, None]) | ((kj >= prompt_pad) & (kj <= prompt_pad + step))
    return torch.where(ok, 0.0, NEG_INF).to(dtype)[:, None, None, :]
