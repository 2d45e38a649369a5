"""Tensor-parallel quantized serving over a (data, model) mesh (port of
radialog_tpu/parallel/tp_serving.py on ``torch.distributed``).

The sharding is Megatron's, as in the JAX package:

  * the float weights are sliced on the host (or the card) before packing,
    so each rank packs its own contiguous W8A8 / W4A8 leaves:
      - wqkv / gateup: column parallel, a rank owns a head group (its q|k|v
        columns, fused again per rank) and an FFN slice;
      - wo / down: row parallel, a rank owns the input rows of its heads /
        FFN slice and re-quantizes them (per-channel scales over its rows;
        at 4 bits the K groups restart at the shard boundary), and
        ``llama_apply(tp_group=...)`` sums the partial outputs over the
        model group before each residual add;
      - embed, norms, lm_head and img_proj: replicated;
  * each rank's int8 cache holds its own heads, (L, B_local, S, H/n * D):
    K2 runs on it unchanged at H/n heads;
  * the global batch is split over ``data``; the logits are replicated
    after the last sum, so every rank of a model group picks the same
    tokens, and the results are gathered back over ``data`` in batch order.

The JAX package runs one controller that stacks every shard on a leading
axis and places it with ``shard_map``. Here every rank is a process that
holds only its own shard (there is no stacked shard axis and no
``_unstack``), and calls ``make_tp_generate``'s function with the same
global inputs as every other rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..core.mesh import (DATA_AXIS, MODEL_AXIS, axis_group, axis_rank, axis_size,
                         host_local_batch_slice)
from ..decode.engine import DecodeParams, GenerationResult, generate, generate_shared_prefix
from ..models.llama import LlamaConfig
from ..ops.layers import BF16, DTypePolicy
from ..ops.quant import _per_layer, quantize_llama_host
from .collectives import gather_batch
from .partition import lora_partition_specs, map_specs, split_leaf


def shard_config(cfg: LlamaConfig, n_shards: int) -> LlamaConfig:
    """Per-shard view: head/KV-head/FFN counts divided, head_dim pinned."""
    if cfg.num_heads % n_shards or cfg.num_kv_heads % n_shards:
        raise ValueError(f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV heads "
                         f"not divisible by model axis {n_shards}")
    if cfg.intermediate_size % n_shards:
        raise ValueError(f"intermediate {cfg.intermediate_size} not divisible "
                         f"by model axis {n_shards}")
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // n_shards,
        num_kv_heads=cfg.num_kv_heads // n_shards,
        intermediate_size=cfg.intermediate_size // n_shards,
        override_head_dim=cfg.head_dim)


def _slice_float_tree(params: Dict, cfg: LlamaConfig, shard: int, n_shards: int) -> Dict:
    """Megatron split of a float tree (``llama_init``'s stacked layers or
    ``convert_llama(stack=False)``'s list of layers; numpy or tensors) for
    one shard: columns of wq/wk/wv/gate/up, rows of wo/down, as per-layer
    views. The replicated leaves are passed through."""
    hd = cfg.head_dim
    qs = slice(shard * (cfg.num_heads // n_shards) * hd,
               (shard + 1) * (cfg.num_heads // n_shards) * hd)
    ks = slice(shard * (cfg.num_kv_heads // n_shards) * hd,
               (shard + 1) * (cfg.num_kv_heads // n_shards) * hd)
    fs = slice(shard * (cfg.intermediate_size // n_shards),
               (shard + 1) * (cfg.intermediate_size // n_shards))
    cols = {"wq": qs, "wk": ks, "wv": ks, "gate": fs, "up": fs}
    rows = {"wo": qs, "down": fs}
    layers = []
    for lay in _per_layer(params["layers"]):
        out = {"input_ln": lay["input_ln"], "post_ln": lay["post_ln"]}
        out.update({name: {"w": lay[name]["w"][:, sl]} for name, sl in cols.items()})
        out.update({name: {"w": lay[name]["w"][sl, :]} for name, sl in rows.items()})
        layers.append(out)
    tree = {"embed": params["embed"], "layers": layers, "final_ln": params["final_ln"],
            "lm_head": params["lm_head"]}
    if "img_proj" in params:
        tree["img_proj"] = params["img_proj"]
    return tree


def shard_quantized_llama(params: Dict, cfg: LlamaConfig, n_shards: int, rank: int,
                          bits: int = 8, device="cuda", w4_mode: str = "asym") -> Dict:
    """A float LLaMA tree -> rank ``rank``'s serving params of ``n_shards``
    (``quantize_llama_host`` of its slice, on ``device``). Column-parallel
    leaves keep the unsharded per-channel scales; the row-parallel wo/down
    are quantized over the shard's rows, so TP > 1 can part from the
    unsharded tokens (tests/test_torch_tp_serving.py). ``bits=4`` packs the
    layers as PackedQ4 (W4A8), the groups restarting at the shard's first
    row."""
    if not 0 <= rank < n_shards:
        raise ValueError(f"rank {rank} outside {n_shards} shards")
    return quantize_llama_host(_slice_float_tree(params, cfg, rank, n_shards), device=device,
                               bits=bits, w4_mode=w4_mode)


def shard_lora(lora: Dict, cfg: LlamaConfig, n_shards: int, rank: int) -> Dict:
    """Rank ``rank``'s LoRA adapters for the TP serving path, split by
    ``lora_partition_specs`` as for training: ``a`` replicated, ``b`` cut to
    the rank's head group (targets wq/wk/wv only: wo would need a row-split
    ``a``). ``cfg`` is unused, kept for the JAX signature."""
    for t, ab in lora["layers"].items():
        if t not in ("wq", "wk", "wv"):
            raise ValueError(f"TP serving LoRA supports q/k/v targets, got {t}")
        if ab["b"].shape[-1] % n_shards:
            raise ValueError(f"{t} width {ab['b'].shape[-1]} not divisible by {n_shards}")
    coords = {DATA_AXIS: (1, 0), MODEL_AXIS: (n_shards, rank)}
    return map_specs(lambda x, s: split_leaf(x, s, coords), lora, lora_partition_specs(lora))


def _as_tensor(x, device, dtype=None):
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype or t.dtype)


def tp_generate(mesh, params: Dict, cfg: LlamaConfig, tokens, lengths,
                dp: DecodeParams = DecodeParams(), img_embs=None, lora: Optional[Dict] = None,
                policy: DTypePolicy = BF16, cache_len: Optional[int] = None,
                kv_int8: bool = True, device="cuda") -> GenerationResult:
    """``make_tp_generate`` built for one call: tokens (B, T) right-padded,
    lengths (B,), img_embs (B, n_img, q_dim) are the GLOBAL batch, the same
    on every rank; B must divide by the data axis. Greedy only."""
    fn = make_tp_generate(mesh, cfg, dp, has_img=img_embs is not None,
                          has_lora=lora is not None, policy=policy, cache_len=cache_len,
                          kv_int8=kv_int8, device=device)
    return fn(params, tokens, lengths, img_embs=img_embs, lora=lora)


def make_tp_generate(mesh, cfg: LlamaConfig, dp: DecodeParams = DecodeParams(), *,
                     has_img: bool = False, has_lora: bool = False,
                     policy: DTypePolicy = BF16, cache_len: Optional[int] = None,
                     kv_int8: bool = True, shared_prefix: bool = False,
                     num_beams: int = 1, device="cuda"):
    """The sharded serving step for this rank of ``mesh`` (a ``make_mesh``
    DeviceMesh, or None for one unsharded rank): returns fn(params,
    tokens, lengths, img_embs=None, lora=None, prefix_tokens=None) ->
    GenerationResult of the global batch. ``params`` / ``lora`` are this
    rank's (``shard_quantized_llama`` / ``shard_lora`` at the model axis's
    size and this rank's coordinate on it). Every rank calls fn with the same
    global inputs; each runs its slice of the batch on the data axis.

    shared_prefix=True: fn takes ``prefix_tokens`` (P0,), the batch-wide
    common prompt, plus per-lane REMAINDER tokens/lengths, and each rank
    runs ``generate_shared_prefix`` over its heads. num_beams > 1: beam
    search (decode/beam.py) over each rank's heads of the bf16 cache; the
    reorder follows the summed logits, so every rank keeps the same beams.
    Requires kv_int8=False and excludes shared_prefix, as in JAX."""
    if dp.do_sample:
        raise NotImplementedError(
            "tp_generate is deterministic (greedy or beam); per-shard RNG "
            "streams under sampling are a separate design decision")
    if num_beams > 1:
        if kv_int8:
            raise ValueError("beam search uses the bf16 KV cache (quality "
                             "path); build the factory with kv_int8=False")
        if shared_prefix:
            raise ValueError("num_beams>1 and shared_prefix are exclusive "
                             "(the beam split-cache owns its prompt region)")
    cfg_local = shard_config(cfg, axis_size(mesh, MODEL_AXIS))
    model_group = axis_group(mesh, MODEL_AXIS)
    data_group = axis_group(mesh, DATA_AXIS)
    n_data, data_rank = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)

    def run(params: Dict, tokens, lengths, img_embs=None, lora: Optional[Dict] = None,
            prefix_tokens=None) -> GenerationResult:
        if shared_prefix and prefix_tokens is None:
            raise ValueError("factory built with shared_prefix=True")
        if has_img and img_embs is None:
            raise ValueError("factory built with has_img=True")
        if has_lora and lora is None:
            raise ValueError("factory built with has_lora=True")
        sl = host_local_batch_slice(len(tokens), data_rank, n_data)
        toks = _as_tensor(tokens, device, torch.int32)[sl]
        lens = _as_tensor(lengths, device, torch.int32)[sl]
        imgs = _as_tensor(img_embs, device)[sl] if has_img else None
        lora_l = lora if has_lora else None
        with torch.no_grad():
            if num_beams > 1:
                from ..decode.beam import generate_beam
                res = generate_beam(params, cfg_local, toks, lens, dp, num_beams,
                                    img_embs=imgs, lora=lora_l, policy=policy,
                                    cache_len=cache_len, tp_group=model_group)
            elif shared_prefix:
                res = generate_shared_prefix(
                    params, cfg_local, _as_tensor(prefix_tokens, device, torch.int32), toks,
                    lens, dp, img_embs=imgs, lora=lora_l, policy=policy, cache_len=cache_len,
                    kv_int8=kv_int8, tp_group=model_group)
            else:
                res = generate(params, cfg_local, toks, lens, dp, img_embs=imgs, lora=lora_l,
                               policy=policy, cache_len=cache_len, kv_int8=kv_int8,
                               tp_group=model_group)
        return GenerationResult(*(gather_batch(x, data_group) for x in res))

    return run
