#!/usr/bin/env python3
"""Free-running greedy agreement of the int8 KV cache against the bf16 cache
(the PyTorch port of tools/measure_kv_int8.py), with a depth sweep.

Both caches decode from the same W8A8 weights and prompts at Vicuna-7B
widths (hidden 4096, 32 heads, head_dim 128), 128-token prompts and 50 new
tokens, so only the cache's dtype differs. Free-running agreement on random
weights measures how fast one early near-tie flip turns into another
trajectory, not the cache's fidelity: the budget is
tools/measure_kv_logit_err_torch.py's teacher-forced error. This tool keeps
the trajectory figure, and ``--layers 1,2,4,8`` shows how it moves with
depth (one JSON line per depth).

On a card the int8 run takes K1 for the projections and K2 for each decode
step's attention, the bf16 run K1 only; ``--device cpu`` runs their plain
versions, a check of the tool at a tiny width, not a card number.

Usage: python3 tools/measure_kv_int8_torch.py [--seeds 8] [--layers 4]
       [--prompt-len 128] [--new-tokens 50] [--batch 4] [--vocab 32001]
       [--fp32] [--hidden 4096] [--heads 32] [--ffn 11008] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.measure_kv_logit_err_torch import device_name, llama_config, serving_weights  # noqa: E402


def measure_seed(params, cfg, toks, lens, new_tokens: int, cache_len: int, policy):
    """Greedy tokens of both caches: (bf16-cache tokens, int8-cache tokens),
    each (B, new_tokens) numpy."""
    import torch
    from radialog_tpu_torch.decode import engine as te
    dp = te.DecodeParams(max_new_tokens=new_tokens, eos_token_id=-1)
    with torch.no_grad():
        ref, got = (te.generate(params, cfg, toks, lens, dp, cache_len=cache_len, policy=policy,
                                kv_int8=kv).tokens.cpu().numpy() for kv in (False, True))
    return ref, got


def agreement(ref: np.ndarray, got: np.ndarray):
    """Per-sequence agreement and first divergent step (new_tokens if none)."""
    agree = (ref == got).mean(axis=1)
    first = [int(np.nonzero(r != g)[0][0]) if (r != g).any() else ref.shape[1]
             for r, g in zip(ref, got)]
    return agree, first


def measure(cfg, seeds: int, batch: int, prompt_len: int, new_tokens: int, fp32: bool = False,
            device="cuda", log=print) -> dict:
    import torch
    from radialog_tpu_torch.ops.layers import BF16, FP32
    cache_len = prompt_len + new_tokens + 14
    policy = FP32 if fp32 else BF16
    agreements, first_div = [], []
    for seed in range(seeds):
        qp = serving_weights(cfg, seed, device)
        rng = np.random.default_rng(seed)
        toks = rng.integers(3, cfg.vocab_size - 2, (batch, prompt_len)).astype(np.int32)
        lens = rng.integers(prompt_len // 2, prompt_len, batch).astype(np.int32)
        ref, got = measure_seed(qp, cfg, torch.from_numpy(toks).to(device),
                                torch.from_numpy(lens).to(device), new_tokens, cache_len,
                                policy)
        agree, first = agreement(ref, got)
        agreements.extend(agree.tolist())
        first_div.extend(first)
        log(f"seed {seed}: per-seq agreement {np.round(agree, 3).tolist()}")
        del qp
    agreements = np.asarray(agreements)
    return {
        "layers": cfg.num_layers, "seeds": seeds, "batch": batch,
        "prompt_len": prompt_len, "new_tokens": new_tokens,
        "mean_agreement": float(agreements.mean()),
        "min_agreement": float(agreements.min()),
        "p10_agreement": float(np.percentile(agreements, 10)),
        "mean_first_divergence_step": float(np.mean(first_div)),
        "frac_fully_identical": float((agreements == 1.0).mean()),
        "device": device_name(device),
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--layers", default="4", help="a depth, or depths separated by commas")
    p.add_argument("--prompt-len", type=int, default=128)
    p.add_argument("--new-tokens", type=int, default=50)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--vocab", type=int, default=32001)
    p.add_argument("--fp32", action="store_true",
                   help="fp32 activations instead of the bf16 serving policy")
    p.add_argument("--hidden", type=int, default=4096)
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--ffn", type=int, default=11008)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    from radialog_tpu_torch.ops.layers import set_precision
    set_precision()
    for layers in (int(x) for x in args.layers.split(",")):
        cfg = llama_config(args.vocab, args.hidden, layers, args.heads, args.ffn)
        print(json.dumps(measure(cfg, args.seeds, args.batch, args.prompt_len,
                                 args.new_tokens, args.fp32, args.device)), flush=True)


if __name__ == "__main__":
    main()
