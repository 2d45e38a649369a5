#!/usr/bin/env python3
"""Teacher-forced per-step decode logit error of the int8 KV cache against
the bf16 cache (the PyTorch port of tools/measure_kv_logit_err.py).

Both caches decode the SAME forced tokens (the bf16-cache greedy
continuation) with the SAME W8A8 weights and the BF16 policy, so the
per-step logit difference is the cache's rounding alone; it is normalized
by each step's logit standard deviation (over the vocabulary). Free-running
decode would compound one early argmax flip into another trajectory, which
measures how sensitive random weights are, not the cache. The weights' own
error on the same normalization comes from tools/measure_quant_torch.py
run on the same card: the int8 cache is within budget when its error here
stays within the W8A8 weights' error there.

On a card the int8 path runs the port's kernels: K1 (W8A8 GEMM) for every
projection and K2 (int8 flash-decode) for every decode step's attention;
``--device cpu`` runs their plain versions, a check of the tool at a tiny
width (``--hidden 64 --heads 4 --ffn 128 --vocab 256``), not a card
number.

Prints "seed i: ..." per seed, then one JSON line: the twin's keys and the
device's name.

Usage: python3 tools/measure_kv_logit_err_torch.py [--seeds 3] [--layers 4]
       [--prompt-len 128] [--steps 32] [--batch 4] [--vocab 32001]
       [--hidden 4096] [--heads 32] [--ffn 11008] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def forced_logits(params, cfg, toks, lens, forced, kv_int8: bool, cache_len: int):
    """Prefill, then one decode step per forced token, BF16: (last prefill
    logits (B, V), per-step logits (B, steps, V)); step i feeds forced[:, i]
    and its logits predict token i + 1."""
    import torch
    from radialog_tpu_torch.decode import engine as te
    from radialog_tpu_torch.ops.layers import BF16
    t = toks.shape[1]
    with torch.no_grad():
        cache, last = te.prefill(params, cfg, toks, lens, cache_len, policy=BF16,
                                 kv_int8=kv_int8)
        rows = [te.decode_step(params, cfg, cache, forced[:, step], lens, t, step,
                               policy=BF16) for step in range(forced.shape[1])]
    return last, torch.stack(rows, 1)


def measure_seed(params, cfg, toks, lens, steps: int, cache_len: int, forced=None):
    """One seed: (normalized error (B, steps), teacher-forced argmax
    agreement, forced tokens (B, steps)). ``forced`` defaults to the
    bf16-cache greedy continuation of ``toks``."""
    import torch
    from radialog_tpu_torch.decode import engine as te
    from radialog_tpu_torch.ops.layers import BF16
    if forced is None:
        dp = te.DecodeParams(max_new_tokens=steps + 1, eos_token_id=-1)
        with torch.no_grad():
            forced = te.generate(params, cfg, toks, lens, dp, policy=BF16,
                                 cache_len=cache_len, kv_int8=False).tokens[:, :steps]
    _, ref = forced_logits(params, cfg, toks, lens, forced, False, cache_len)
    _, got = forced_logits(params, cfg, toks, lens, forced, True, cache_len)
    ref = ref.float().cpu().numpy()
    got = got.float().cpu().numpy()
    sigma = ref.std(axis=-1)                         # (B, steps)
    err = np.abs(got - ref).mean(-1) / sigma
    agree = float((got.argmax(-1) == ref.argmax(-1)).mean())
    return err, agree, forced.cpu().numpy()


def llama_config(vocab: int, hidden: int, layers: int, heads: int, ffn: int):
    from radialog_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
                       num_heads=heads, num_kv_heads=heads, intermediate_size=ffn)


def device_name(device) -> str:
    import torch
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def serving_weights(cfg, seed: int, device):
    """W8A8 serving params of ``llama_init``'s float weights drawn from a
    generator seeded with ``seed`` on ``device``."""
    import torch
    from radialog_tpu_torch.models.llama import llama_init
    from radialog_tpu_torch.ops.quant import quantize_llama_host
    gen = torch.Generator(device=device).manual_seed(seed)
    params = llama_init(gen, cfg, device=device)
    qp = quantize_llama_host(params, device=device)
    del params
    return qp


def measure(cfg, seeds: int, batch: int, prompt_len: int, steps: int, device="cuda",
            log=print) -> dict:
    import torch
    t = prompt_len
    cache_len = t + steps + 8
    per_step_err, argmax_agree = [], []
    for seed in range(seeds):
        qp = serving_weights(cfg, seed, device)
        rng = np.random.default_rng(seed)
        toks = rng.integers(3, cfg.vocab_size - 2, (batch, t)).astype(np.int32)
        toks = torch.from_numpy(toks).to(device)
        lens = torch.from_numpy(rng.integers(t // 2, t, batch).astype(np.int32)).to(device)
        err, agree, _ = measure_seed(qp, cfg, toks, lens, steps, cache_len)
        per_step_err.append(err)
        argmax_agree.append(agree)
        log(f"seed {seed}: step-mean normalized err {per_step_err[-1].mean():.5f}")
        del qp
    err = np.concatenate(per_step_err, axis=0)       # (N, steps)
    return {
        "mode": "kv_int8 vs bf16 KV (same W8A8 weights, teacher-forced)",
        "layers": cfg.num_layers, "seeds": seeds, "batch": batch,
        "prompt_len": t, "steps": steps,
        "logit_err_per_sigma_mean": round(float(err.mean()), 5),
        "logit_err_per_sigma_p95": round(float(np.percentile(err, 95)), 5),
        "logit_err_last_step": round(float(err[:, -1].mean()), 5),
        "argmax_agreement_teacher_forced": round(float(np.mean(argmax_agree)), 4),
        "device": device_name(device),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=32001)
    ap.add_argument("--hidden", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--ffn", type=int, default=11008)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from radialog_tpu_torch.ops.layers import set_precision
    set_precision()
    cfg = llama_config(args.vocab, args.hidden, args.layers, args.heads, args.ffn)
    print(json.dumps(measure(cfg, args.seeds, args.batch, args.prompt_len, args.steps,
                             args.device)))


if __name__ == "__main__":
    main()
