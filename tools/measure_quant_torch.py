#!/usr/bin/env python3
"""The quality budget of the quantized serving modes (the PyTorch port of
tools/measure_quant.py), at Vicuna-7B widths (hidden 4096, 32 heads, FFN
11008, vocab 32001) cut in depth so that every copy fits on the card.

1. The transferable metric: the last-position prefill logit error of bf16,
   W8A8 and W4A8 (``--w4-mode asym|sym|both``) against an FP32 oracle of the
   same float weights, normalized by the oracle's logit standard deviation.
   A quantized mode whose error is a small multiple of bf16's own is as
   principled to serve as bf16.
2. Greedy-token agreement with the bf16 forward over --tokens new tokens,
   each mode decoding over the bf16 cache. On random weights the logits
   are near-uniform over 32,000 classes, so any rounding flips an argmax:
   this agreement is context for the first metric, not a quality measure.

On a card the W8A8 projections run K1 and the W4A8 ones K4 (the lm_head
stays W8A8: K1); ``--device cpu`` runs their plain versions, a check of
the tool at a tiny width, not a card number. The W4A8 packer runs on the
host (``pack_q4``), the slowest part at full width.

Prints one JSON line per mode (bf16, w8a8, w4a8-<grid>...): the twin's keys
and the device's name.

Usage: python3 tools/measure_quant_torch.py [--layers 4] [--seeds 3]
       [--tokens 50] [--batch 8] [--prompt-len 64] [--w4-mode asym]
       [--vocab 32001] [--hidden 4096] [--heads 32] [--ffn 11008]
       [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.measure_kv_logit_err_torch import device_name, llama_config  # noqa: E402

NOTE = ("random-weight argmax agreement is a meaningless quality metric "
        "(near-uniform logits): compare logit_err to the bf16 row instead")


def modes_of(w4_mode: str):
    """(name, bits, grid) of every quantized mode the flag asks for."""
    grids = ["asym", "sym"] if w4_mode == "both" else [w4_mode]
    return [("w8a8", 8, "asym")] + [(f"w4a8-{g}", 4, g) for g in grids]


def last_logits(params, cfg, toks, lens, policy):
    """Last-position prefill logits (B, V) in f32, without a cache."""
    import torch
    from radialog_tpu_torch.models.llama import llama_apply, prefill_bias
    b, t = toks.shape
    positions = torch.arange(t, device=toks.device)[None].repeat(b, 1)
    with torch.no_grad():
        logits, _ = llama_apply(params, cfg, toks, positions, prefill_bias(lens, t),
                                lengths=lens, policy=policy, last_pos=lens - 1)
    return logits[:, 0].float()


def measure_seed(params32, cfg, toks, lens, tokens: int, modes, cache_len: int,
                 on_params=None):
    """One seed from the float weights ``params32`` (``llama_init``'s
    stacked f32 tree): {mode: (normalized logit error, greedy agreement or
    None)} for "bf16" and each of ``modes``. ``on_params(name, params)``
    sees each quantized serving tree before it is dropped."""
    import torch
    from radialog_tpu_torch.decode import engine as te
    from radialog_tpu_torch.ops.layers import BF16, FP32
    from radialog_tpu_torch.ops.quant import quantize_llama_host
    dp = te.DecodeParams(max_new_tokens=tokens, eos_token_id=-1)
    dev = toks.device
    oracle = last_logits(params32, cfg, toks, lens, FP32)
    scale = oracle.std(unbiased=False)

    def err(p):
        return float((last_logits(p, cfg, toks, lens, BF16) - oracle).abs().mean() / scale)

    def greedy(p):
        with torch.no_grad():
            return te.generate(p, cfg, toks, lens, dp, policy=BF16, cache_len=cache_len,
                               kv_int8=False).tokens
    params16 = _bf16(params32)
    out = {"bf16": (err(params16), None)}
    ref = greedy(params16)
    del params16
    for name, bits, grid in modes:
        qp = quantize_llama_host(params32, device=dev, bits=bits, w4_mode=grid)
        out[name] = (err(qp), float((greedy(qp) == ref).float().mean()))
        if on_params is not None:
            on_params(name, qp)
        del qp
    return out


def _bf16(x):
    import torch
    if isinstance(x, dict):
        return {k: _bf16(v) for k, v in x.items()}
    return x.to(torch.bfloat16)


def measure(cfg, seeds: int, tokens: int, batch: int, prompt_len: int, w4_mode: str,
            device="cuda", on_params=None):
    """The tool's rows over ``seeds`` seeds (weights from ``llama_init`` with
    a generator of that seed on ``device``, tokens from numpy's)."""
    import torch
    from radialog_tpu_torch.models.llama import llama_init
    modes = modes_of(w4_mode)
    cache_len = prompt_len + tokens + 14
    errs = {"bf16": [], **{name: [] for name, _, _ in modes}}
    agree = {name: [] for name, _, _ in modes}
    for seed in range(seeds):
        params32 = llama_init(torch.Generator(device=device).manual_seed(seed), cfg,
                              device=device)
        rng = np.random.default_rng(seed)
        toks = torch.from_numpy(rng.integers(3, min(30000, cfg.vocab_size - 1),
                                             (batch, prompt_len)).astype(np.int32)).to(device)
        lens = torch.full((batch,), prompt_len, dtype=torch.int32, device=device)
        seen = None if on_params is None else (lambda name, p: on_params(seed, name, p))
        for name, (e, a) in measure_seed(params32, cfg, toks, lens, tokens, modes,
                                         cache_len, seen).items():
            errs[name].append(e)
            if a is not None:
                agree[name].append(a)
        del params32
    rows = []
    for name in errs:
        row = {"mode": name, "hidden": cfg.hidden_size, "heads": cfg.num_heads,
               "layers": cfg.num_layers, "seeds": seeds, "tokens": tokens, "batch": batch,
               "logit_err_vs_fp32": round(float(np.mean(errs[name])), 5)}
        if name in agree:
            row["greedy_agreement_vs_bf16"] = round(float(np.mean(agree[name])), 4)
            row["note"] = NOTE
        row["device"] = device_name(device)
        rows.append(row)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--tokens", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--w4-mode", default="asym", choices=["asym", "sym", "both"],
                    help="int4 grid: asym = MSE-optimal clipped asymmetric (the default); "
                         "sym = symmetric absmax; both = a row per grid")
    ap.add_argument("--vocab", type=int, default=32001)
    ap.add_argument("--hidden", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--ffn", type=int, default=11008)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from radialog_tpu_torch.ops.layers import set_precision
    set_precision()
    cfg = llama_config(args.vocab, args.hidden, args.layers, args.heads, args.ffn)
    for row in measure(cfg, args.seeds, args.tokens, args.batch, args.prompt_len,
                       args.w4_mode, args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
