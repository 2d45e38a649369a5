#!/usr/bin/env python3
"""Speculative-decoding bench of the PyTorch port: batch-1 Vicuna-7B greedy
on one GPU (the port of tools/bench_spec.py).

A (k+1)-token verify forward reads the same weights as a 1-token decode
step, so it should cost little more; this tool measures that trade for the
prompt-lookup engine (``decode/speculative.py generate_spec``):

  plain      the 1-token loop (``decode/engine.py generate``), the baseline
  oracle     drafts = the plain run's own greedy stream: every draft is
             accepted, the upper bound and the verify forward's cost
  ngram      the shipped prompt-lookup drafter on the same prompt
  junk       drafts that never match: the overhead floor at zero acceptance
  realistic  (``--accept-pattern``) drafts that match the true stream for
             pattern[i] tokens on verify i, cycling, then miss

Every mode's tokens must equal the plain run's (asserted, as in the JAX
tool). The drafters take ``generate_spec``'s proposer signature (hist,
hist_len) -> (k,); the batchers of tools/bench_spec_ring_torch.py take the
whole batch. The weights are ``tools/bench_torch.py
build_serving_params``'s constant W8A8 tiles: every projection is K1; the
448-token prefill's attention is K3 (csrc/flash_attention.cu); the verify's
attention is plain PyTorch by design (models/llama.py
``_attention_int8_verify`` over the int8 cache, ``mha`` over bf16); the
plain loop decodes with K2 over the int8 cache (``--kv-int8``). With
constant weights the greedy text is degenerate and the ngram drafter's
acceptance is no real-text figure.

One warm-up call per mode, then ``--runs`` timed calls, each ended by
``torch.cuda.synchronize()`` before the clock is read; each row keeps the
fastest, as the JAX tool does. Prints the JAX tool's header line, then one
line per mode: its keys, ``device`` (the card's name and power limit) and
``runs_s`` (every timed call's seconds; in the header, by mode).
``--device cpu`` runs the plain versions at a tiny model, a check of the
tool, not a number.

Usage: python3 tools/bench_spec_torch.py [--k 5] [--prompt-len 448]
       [--new-tokens 300] [--kv-int8] [--runs 2] [--accept-pattern 1,2]
       [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.bench_torch import (Model, build_models, device_label, draw_ids,  # noqa: E402
                               full_model, open_device, policy_of, timed)

NOTE = ("oracle = full-acceptance upper bound; junk = zero-acceptance overhead floor; "
        "ngram = the shipped drafter (constant-weight greedy text degenerates into "
        "repetition, which prompt-lookup catches; real-text acceptance is workload-"
        "dependent, highest on correction/QA turns)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=5, help="draft tokens per step")
    ap.add_argument("--m", type=int, default=3, help="n-gram match length")
    ap.add_argument("--prompt-len", type=int, default=448,
                    help="correction-turn scale: conversation + report")
    ap.add_argument("--new-tokens", type=int, default=300)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--accept-pattern", type=str, default=None,
                    help="comma-separated ints: adds a 'realistic' mode whose drafts match "
                         "the true greedy stream for pattern[i] tokens on verify i (cycling), "
                         "then miss")
    ap.add_argument("--device", default="cuda")
    return ap


def pattern_table(stream: np.ndarray, pattern: List[int], k: int, pl: int,
                  n_new: int) -> np.ndarray:
    """Drafts indexed by the live history length: on iteration i they match
    ``stream`` for pattern[i % len] tokens, then miss (the JAX tool's
    emission walk: each iteration emits accepted + 1)."""
    tbl = np.ones((pl + n_new + k + 2, k), np.int32)
    c, it = 1, 0
    while c < n_new:
        acc = min(pattern[it % len(pattern)], k, n_new - c - 1)
        row = np.where(stream[c:c + k] == 1, 2, 1)[:k]
        row = np.concatenate([row, np.ones(k - len(row), np.int32)])
        row[:acc] = stream[c:c + acc]
        tbl[pl + c] = row
        c += acc + 1
        it += 1
    return tbl


def drafters(stream: np.ndarray, args, pl: int, device) -> List:
    """[(mode, proposer or None)] in the JAX tool's order, each proposer
    ``(hist (H,), hist_len) -> (k,)`` on the device."""
    import torch
    k = args.k
    oracle_tbl = torch.from_numpy(np.concatenate([stream, np.zeros(k, np.int32)])).to(device)
    ones = torch.ones(k, dtype=torch.int32, device=device)

    def oracle(hist, hist_len):     # start clamped into the table, as dynamic_slice's
        start = min(max(hist_len - pl, 0), oracle_tbl.shape[0] - k)
        return oracle_tbl[start:start + k]

    def junk(hist, hist_len):
        return ones

    modes = [("oracle", oracle), ("ngram", None), ("junk", junk)]
    if args.accept_pattern:
        pattern = [int(x) for x in args.accept_pattern.split(",")]
        tbl = torch.from_numpy(pattern_table(stream, pattern, k, pl,
                                             args.new_tokens)).to(device)

        def realistic(hist, hist_len):
            return tbl[min(max(hist_len, 0), tbl.shape[0] - 1)]
        modes.append(("realistic", realistic))
    return modes


def spec_calls(args, models: Dict, model: Model, device):
    """(the prompt, plain(), spec(proposer)): the two engine calls the tool
    times, on a numpy-seeded prompt."""
    import torch
    from radialog_tpu_torch.decode.engine import DecodeParams, generate
    from radialog_tpu_torch.decode.speculative import generate_spec
    cfg, t = model.llama, args.prompt_len
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(draw_ids(rng, cfg, (1, t))).to(device)
    lengths = torch.full((1,), t, dtype=torch.int32, device=device)
    dp = DecodeParams(max_new_tokens=args.new_tokens, eos_token_id=-1)
    cache_len = -(-(t + args.new_tokens + args.k + 1) // 128) * 128
    kw = dict(lora=models["lora"], policy=policy_of(model), cache_len=cache_len,
              kv_int8=args.kv_int8)

    @torch.no_grad()
    def plain():
        return generate(models["params"], cfg, tokens, lengths, dp, **kw)

    @torch.no_grad()
    def spec(proposer):
        return generate_spec(models["params"], cfg, tokens, dp, k=args.k, m=args.m,
                             proposer=proposer, **kw)
    return tokens, plain, spec


def run(args, models: Dict, model: Model, device) -> List[Dict]:
    t = args.prompt_len
    _, plain, spec = spec_calls(args, models, model, device)
    out, runs_s = {}, {}
    res, runs_s["plain"] = timed(plain, args.runs, device)
    wall = min(runs_s["plain"])
    n = int(res.lengths[0])
    plain_tokens = res.tokens.cpu()
    out["plain"] = {"mode": "plain", "tok_s": round(n / wall, 1), "forwards": n,
                    "ms_per_forward": round(1e3 * wall / n, 2), "accepted_per_forward": 1.0}
    stream = plain_tokens[0].numpy().astype(np.int32)
    for mode, proposer in drafters(stream, args, t, device):
        res, runs_s[mode] = timed(lambda p=proposer: spec(p), args.runs, device)
        wall = min(runs_s[mode])
        if not bool((res.tokens.cpu() == plain_tokens).all()):
            raise AssertionError(f"{mode} output diverged from plain greedy")
        it = int(res.iters) + 1     # + the prefill forward's first token
        n = int(res.lengths[0])
        out[mode] = {"mode": mode, "tok_s": round(n / wall, 1), "forwards": it,
                     "ms_per_forward": round(1e3 * wall / it, 2),
                     "accepted_per_forward": round(n / it, 2)}
    label = device_label(device)
    hdr = {"k": args.k, "m": args.m, "prompt_len": t, "new_tokens": args.new_tokens,
           "kv": "int8" if args.kv_int8 else "bf16", "note": NOTE}
    if args.accept_pattern:
        hdr["accept_pattern"] = args.accept_pattern
    lines = [{**hdr, "device": label,
              "runs_s": {k: [round(x, 4) for x in v] for k, v in runs_s.items()}}]
    lines += [{**row, "device": label, "runs_s": [round(x, 4) for x in runs_s[mode]]}
              for mode, row in out.items()]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


def main(argv: Optional[List[str]] = None, model: Optional[Model] = None) -> List[Dict]:
    args = build_parser().parse_args(argv)
    dev = open_device(args.device)
    model = model or full_model()
    return run(args, build_models(model, dev, vision=False), model, dev)


if __name__ == "__main__":
    main()
