#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port: chest X-ray to radiology report,
end to end, on one NVIDIA GPU (the port of the root bench.py; the metric is
reports/s on one card).

The measured pass, at Vicuna-7B shapes:
  448 x 448 image -> BioViL-T (ResNet-50 + projector, J = 1408)
                  -> ln_vision + Q-Former (BERT-base, 32 queries)
                  -> <IMG>-spliced Vicuna-7B prefill, W8A8 weights (K1,
                     csrc/q8_matmul.cu, every projection and the lm_head)
                  -> greedy decode of 300 new tokens over the int8
                     token-flat KV cache (K2, csrc/flash_decode.cu)
This is the port's serving default: ``decode/engine.py
generate_shared_prefix`` with the 48 prompt tokens every report request
shares (the Vicuna system prompt and "USER: Image information: ") prefilled
once and read once a decode step, each lane's cache holding its own 80
prompt tokens and 300 new ones in 384 slots; batch 56.

The weights are synthetic, as in the JAX tool: constant int8 weights (every
value 3, scale 1/(127 sqrt(K))) in the port's own (N, K) layout, a random
bf16 embedding table, random vision, Q-Former and LoRA weights from a seeded
generator. Their values do not change the work; the metric measures the
engine's throughput at the real shapes. ``DecodeParams(unroll=3)`` is passed
as JAX's tool passes it; in the port it sizes nothing here and changes no
step (decode/engine.py: it only spaces the checks of the early exit).

One warm-up pass, then 3 timed passes, each ended by
``torch.cuda.synchronize()`` before the clock is read. Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", "runs_s"}; ``device``
is the card's name and power limit as nvidia-smi reports them, ``runs_s``
each timed pass's seconds (the host's speed varies between calls: compare
two versions only inside one call).

``vs_baseline`` divides by the JAX tool's 0.40 reports/s: an estimate, not a
measurement, of the reference's HF ``generate`` (fp16 Vicuna-7B, batch 12,
300 new tokens) on an A40-class GPU (BASELINE.md, bracket 0.27-0.60).

``build_serving_params`` lives here, as in the JAX package, where the other
bench tools import it from. Unlike the JAX tool, there is no fallback: an
exception ends the run with a non-zero exit code. ``--device cpu`` runs the
kernels' plain versions, a check of the tool at a tiny model (``main``'s
``model`` and ``shape`` arguments), not a number.

Usage: python3 tools/bench_torch.py [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

REFERENCE_REPORTS_PER_SEC = 0.40   # the JAX tool's estimate, see the docstring


@dataclasses.dataclass(frozen=True)
class Shape:
    """The report pass's shapes and depth."""
    batch: int = 56                # the JAX tool's batch
    prompt_len: int = 128          # system prompt + findings + instruction
    shared_prefix: int = 48        # tokens every report request shares
    new_tokens: int = 300          # test.py's max_new_tokens
    lane_cache: int = 384          # 80 + 300 rounded up to K2's 32-slot blocks
    runs: int = 3


@dataclasses.dataclass(frozen=True)
class Model:
    """The model's widths: Vicuna-7B, the Q-Former over BioViL-T at 448 px
    by default; ``tiny_model()`` for a check on the CPU."""
    llama: Any = None
    blip2: Any = None
    image_size: int = 448
    resnet_layers: Tuple[int, ...] = (3, 4, 6, 3)
    bottleneck: bool = True
    bf16: bool = True


def full_model() -> Model:
    from radialog_tpu_torch.models.blip2 import Blip2Config
    from radialog_tpu_torch.models.llama import VICUNA_7B
    return Model(VICUNA_7B, Blip2Config())


def tiny_model() -> Model:
    """TINY_LLAMA with as many <IMG> slots as TINY_QFORMER has queries, a
    one-block ResNet and 64 px images, FP32 (the mock pipeline's policy)."""
    from radialog_tpu_torch.models.blip2 import Blip2Config
    from radialog_tpu_torch.models.llama import TINY_LLAMA
    from radialog_tpu_torch.models.qformer import TINY_QFORMER
    llama = dataclasses.replace(TINY_LLAMA, num_img_tokens=TINY_QFORMER.num_query_tokens,
                                max_position=512, qformer_dim=TINY_QFORMER.bert.hidden_size)
    return Model(llama, Blip2Config(qformer=TINY_QFORMER), image_size=64,
                 resnet_layers=(1, 1, 1, 1), bottleneck=False, bf16=False)


def policy_of(model: Model):
    from radialog_tpu_torch.ops.layers import BF16, FP32
    return BF16 if model.bf16 else FP32


# ------------------------------------------------------------ the device
def open_device(name: str):
    """The torch device ``--device`` names; a card that is not there raises
    (no fallback to the CPU). On a card, full-float32 matmuls (TF32 off)."""
    import torch
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
        from radialog_tpu_torch.ops.layers import set_precision
        set_precision()
    return dev


def device_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or "cpu"."""
    import torch
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def clock(device) -> float:
    """time.perf_counter() after everything queued on ``device`` finished."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def timed(fn: Callable, runs: int, device, warm: int = 1):
    """``warm`` untimed calls of fn(), then ``runs`` timed ones: (the last
    result, each timed call's seconds)."""
    res = None
    for _ in range(warm):
        res = fn()
    secs = []
    for _ in range(runs):
        t0 = clock(device)
        res = fn()
        secs.append(clock(device) - t0)
    return res, secs


def free(device) -> None:
    """Release what the last tool left behind before the next allocates."""
    import gc
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def draw_ids(rng: np.random.Generator, cfg, shape) -> np.ndarray:
    """Token ids as the JAX tools draw them, rng.integers(3, 30000), kept
    below the vocabulary of a tiny model (the same draws at full width)."""
    return rng.integers(3, min(30000, cfg.vocab_size - 1), shape).astype(np.int32)


# ------------------------------------------------------------- weights
def build_serving_params(cfg, gen, bits: int = 8, device="cuda") -> Dict:
    """Serving weights at ``cfg``'s shapes in the port's layout (fused wqkv
    and gateup, as ops/quant.py quantize_llama_host packs them): constant
    int8 weights (N, K), every value 3, scale 1/(127 sqrt(K)) in f32, as
    the JAX tool's constant tiles (values do not change the work; a random
    int8 draw would first make int32 on the card). ``bits=4`` builds W4A8
    layer leaves (K4): nibbles 1 and 2 in every byte, group scales
    1/(7 sqrt(K)) and offsets 1e-6, so the asymmetric kernel runs, as the
    serving packs do. The lm_head is int8 at either width; the embedding
    table is random bf16 from ``gen``."""
    import torch
    from radialog_tpu_torch.ops.q4_matmul import GROUP, PackedQ4, pick_bk
    from radialog_tpu_torch.ops.q8_matmul import PackedQ8
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    h, inter, L, V = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    kvh = cfg.num_kv_heads * cfg.head_dim

    def leaf8(k: int, n: int) -> PackedQ8:
        return PackedQ8(torch.full((n, k), 3, dtype=torch.int8, device=device),
                        torch.full((n,), k ** -0.5 / 127.0, dtype=torch.float32, device=device))

    def leaf4(k: int, n: int) -> PackedQ4:
        bk = pick_bk(k)
        group = GROUP if bk % GROUP == 0 else bk
        groups = -(-k // bk) * bk // group
        return PackedQ4(torch.full((n, k // 2), 0x21, dtype=torch.int8, device=device),
                        torch.full((groups, n), k ** -0.5 / 7.0, device=device), group,
                        torch.full((groups, n), 1e-6, device=device))

    leaf = leaf8 if bits == 8 else leaf4
    embed = torch.randn((V, h), generator=gen, device=device) * 0.02
    return {"embed": embed.to(torch.bfloat16),
            "layers": [{"wqkv": leaf(h, h + 2 * kvh), "wo": leaf(h, h),
                        "gateup": leaf(h, 2 * inter), "down": leaf(inter, h),
                        "input_ln": torch.ones(h, device=device),
                        "post_ln": torch.ones(h, device=device)} for _ in range(L)],
            "final_ln": torch.ones(h, device=device),
            "lm_head": leaf8(h, V)}


def build_models(model: Model, device, seed: int = 0, bits: int = 8, vision: bool = True):
    """{"params", "lora", and with ``vision`` "vis_params", "vis_state",
    "qf"}: the serving weights, bf16 LoRA (fp32 at a float policy), and the
    BioViL-T, Q-Former and ln_vision weights, from one generator seeded with
    ``seed`` on ``device``."""
    import torch
    from radialog_tpu_torch.models.biovil_t import biovil_t_init
    from radialog_tpu_torch.models.llama import lora_init
    from radialog_tpu_torch.models.qformer import qformer_init
    from radialog_tpu_torch.ops.layers import layernorm_init
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = torch.bfloat16 if model.bf16 else torch.float32
    out = {"params": build_serving_params(model.llama, gen, bits=bits, device=device),
           "lora": lora_init(gen, model.llama, device=device, dtype=dtype)}
    if vision:
        width = model.blip2.qformer.encoder_width
        out["vis_params"], out["vis_state"] = biovil_t_init(
            gen, device, joint_feature_size=width, resnet_layers=model.resnet_layers,
            bottleneck=model.bottleneck)
        out["qf"] = {"qformer": qformer_init(gen, model.blip2.qformer, device),
                     "ln_vision": layernorm_init(width, device)}
    return out


# ---------------------------------------------------------- the timed pass
def embed_images(models: Dict, model: Model, images):
    """(B, S, S, 3) float in [0, 1] -> the Q-Former's query embeddings:
    BioViL-T, its patch tokens, ln_vision, the Q-Former."""
    from radialog_tpu_torch.models.biovil_t import biovil_t_apply, patch_tokens_for_qformer
    from radialog_tpu_torch.models.blip2 import blip2_forward_image
    from radialog_tpu_torch.ops.layers import layernorm
    policy = policy_of(model)
    out = biovil_t_apply(models["vis_params"], models["vis_state"], images, policy=policy)
    patch = patch_tokens_for_qformer(out.projected_patch_embeddings)
    patch = layernorm(models["qf"]["ln_vision"], patch)
    return blip2_forward_image(models["qf"], model.blip2, patch, policy=policy)


def report_inputs(model: Model, shape: Shape, device, seed: int = 0) -> Dict:
    """The JAX tool's inputs, drawn in its order from numpy's generator:
    float images, the shared prefix, the per-lane remainders with the <IMG>
    run at 4, their lengths."""
    import torch
    cfg = model.llama
    rng = np.random.default_rng(seed)
    s = model.image_size
    images = rng.random((shape.batch, s, s, 3)).astype(np.float32)
    prefix = draw_ids(rng, cfg, (shape.shared_prefix,))
    t1 = shape.prompt_len - shape.shared_prefix
    rem = draw_ids(rng, cfg, (shape.batch, t1))
    rem[:, 4:4 + cfg.num_img_tokens] = cfg.img_token_id
    return {"images": torch.from_numpy(images).to(device),
            "prefix": torch.from_numpy(prefix).to(device),
            "tokens": torch.from_numpy(rem).to(device),
            "lengths": torch.full((shape.batch,), t1, dtype=torch.int32, device=device)}


def report_step(models: Dict, model: Model, shape: Shape, inputs: Dict, embs=None):
    """The timed pass: the images' query embeddings (or ``embs`` given),
    then ``generate_shared_prefix`` over the int8 cache."""
    import torch
    from radialog_tpu_torch.decode.engine import DecodeParams, generate_shared_prefix
    # unroll=3 as the JAX tool passes it; the port's decode changes no step for it
    dp = DecodeParams(max_new_tokens=shape.new_tokens, eos_token_id=-1, unroll=3)
    with torch.no_grad():
        if embs is None:
            embs = embed_images(models, model, inputs["images"])
        return generate_shared_prefix(
            models["params"], model.llama, inputs["prefix"], inputs["tokens"],
            inputs["lengths"], dp, img_embs=embs, lora=models["lora"],
            policy=policy_of(model), cache_len=shape.lane_cache, kv_int8=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    return ap


def run(models: Dict, model: Model, shape: Shape, device) -> Dict:
    """The warm-up and timed passes on ``models`` (``build_models``'s
    keys): the JSON line."""
    inputs = report_inputs(model, shape, device)
    res, runs_s = timed(lambda: report_step(models, model, shape, inputs), shape.runs, device)
    assert res.tokens.shape == (shape.batch, shape.new_tokens)
    rps = shape.runs * shape.batch / sum(runs_s)
    line = {"metric": "reports_per_sec_per_chip", "value": round(rps, 4),
            "unit": (f"reports/s (image->{shape.new_tokens}-token report e2e, Vicuna-7B "
                     "shapes, synthetic W8A8 weights (K1) + int8 token-flat KV (K2) + "
                     f"shared-prefix serving, batch {shape.batch})"),
            "vs_baseline": round(rps / REFERENCE_REPORTS_PER_SEC, 3),
            "device": device_label(device), "runs_s": [round(x, 4) for x in runs_s]}
    print(json.dumps(line), flush=True)
    return line


def main(argv: Optional[List[str]] = None, model: Optional[Model] = None,
         shape: Optional[Shape] = None) -> Dict:
    args = build_parser().parse_args(argv)
    dev = open_device(args.device)
    model = model or full_model()
    return run(build_models(model, dev), model, shape or Shape(), dev)


if __name__ == "__main__":
    main()
