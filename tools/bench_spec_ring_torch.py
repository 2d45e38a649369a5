#!/usr/bin/env python3
"""Batched speculative decoding bench of the PyTorch port:
``SpecRingBatcher`` (or ``SpecCompactBatcher``, ``--compact``) against
``RingBatcher`` at Vicuna-7B on one GPU (the port of
tools/bench_spec_ring.py).

The JAX tool's protocol: constant weights make text with no real n-gram
structure, so the honest rows are the controlled ones:

  plain    ``RingBatcher``, the baseline
  oracle   drafts = the plain run's greedy stream (every lane has the same
           prompt, so one table indexed by the live history length serves
           every lane): every draft accepted, the upper bound
  pattern  drafts matching the true stream for pattern[i] tokens on verify
           i ('1,2': 2.5 tokens a verify), then missing
  junk     drafts that never match: the zero-acceptance floor
  ngram    the shipped drafter (no real-text claim on such text)

The port's batchers call the proposer with the whole batch, (hist (B, H),
hist_lens (B,)) -> (B, k) (a deliberate difference from JAX's vmapped
one-row proposer), so the drafters are written to that signature.
``SpecRingBatcher`` runs over the bf16 ring only: ``--kv-int8`` without
``--compact`` is refused before anything is built, as the batcher itself
refuses it. The spec ring spends k + 1 slots a verify whatever it accepts,
so its cache is sized for zero acceptance; both caches are reported.

Weights: ``tools/bench_torch.py build_serving_params`` (constant W8A8:
every projection K1; each 448-token admission's prefill attention K3;
the verify's attention is plain PyTorch). ``--tiny``: TINY_LLAMA on the
CPU whatever ``--device`` says, as in the JAX tool: its float weights from
``llama_init`` quantized by ``quantize_llama_host``, no LoRA, the BF16
policy; a check of the protocol, not a number.

One warm-up drain per mode, then ``--runs`` timed drains of ``--lanes``
sessions, each ended by ``torch.cuda.synchronize()`` before the clock is
read; each row keeps the fastest. Prints the JAX tool's header, then one
line per mode: its keys, ``device`` (the card's name and power limit) and
``runs_s`` (every timed drain's seconds; in the header, by mode).

Usage: python3 tools/bench_spec_ring_torch.py [--k 5] [--lanes 4]
       [--new-tokens 300] [--pattern 1,2] [--runs 2] [--compact [--kv-int8]]
       [--tiny] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.bench_spec_torch import pattern_table  # noqa: E402
from tools.bench_torch import (Model, build_models, clock, device_label, free,  # noqa: E402
                               full_model, open_device, policy_of)

NOTE = ("oracle = full-acceptance bound; junk = zero-acceptance floor; pattern = "
        "controlled realistic acceptance; ngram rate on synthetic text is not a "
        "real-text claim")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--m", type=int, default=3)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=448,
                    help="correction-turn scale: conversation + report")
    ap.add_argument("--new-tokens", type=int, default=300)
    ap.add_argument("--spc-plain", type=int, default=8,
                    help="plain ring decode steps per call")
    ap.add_argument("--spc-spec", type=int, default=4,
                    help="spec ring verify iterations per call")
    ap.add_argument("--pattern", type=str, default="1,2")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--tiny", action="store_true",
                    help="TINY_LLAMA on the CPU: a protocol check, not a measurement")
    ap.add_argument("--compact", action="store_true",
                    help="SpecCompactBatcher (fixed scratch window + relocation): the "
                         "plain decode's cache size instead of (k+1) slots a verify")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (compact mode only)")
    ap.add_argument("--device", default="cuda")
    return ap


def tiny_params(device="cpu"):
    """TINY_LLAMA's float weights from ``llama_init`` (a generator seeded
    0), quantized for serving."""
    import torch
    from radialog_tpu_torch.models.llama import TINY_LLAMA, llama_init
    from radialog_tpu_torch.ops.quant import quantize_llama_host
    base = llama_init(torch.Generator().manual_seed(0), TINY_LLAMA, device="cpu")
    return quantize_llama_host(base, device=device)


def cache_sizes(args):
    """(prompt region, plain ring cache, spec cache): the JAX tool's sizing."""
    t, n_new, kp1 = args.prompt_len, args.new_tokens, args.k + 1
    preg = max(32, -(-t // 32) * 32)
    ring_p = -(-max(n_new - 1, 1) // args.spc_plain) * args.spc_plain + args.spc_plain
    ring_p = max(-(-ring_p // 32) * 32, 64)
    if args.compact:
        nv_life = -(-max(n_new - 1, 1) // args.spc_spec) * args.spc_spec + args.spc_spec
        ring_s = max(-(-max(n_new + kp1, nv_life + 1) // 32) * 32, 64)
    else:
        nv_life = -(-max(n_new - 1, 1) // args.spc_spec) * args.spc_spec
        ring_s = (nv_life + args.spc_spec) * kp1
        ring_s = -(-ring_s // kp1) * kp1
    return preg, preg + ring_p, preg + ring_s


def batch_drafters(stream: np.ndarray, args, pl: int, device) -> List:
    """[(mode, proposer or None)] in the JAX tool's order, each proposer
    taking the whole batch: (hist (B, H), hist_lens (B,)) -> (B, k)."""
    import torch
    k = args.k
    oracle_tbl = torch.from_numpy(np.concatenate([stream, np.zeros(k + 2, np.int32)])
                                  ).to(device)
    ar = torch.arange(k, device=device)
    # the JAX drafters' dynamic_slice clamps its start into the table (an
    # idle lane's history length is 0)

    def oracle(hist, hist_lens):
        start = (hist_lens.long() - pl).clamp(0, oracle_tbl.shape[0] - k)
        return oracle_tbl[start[:, None] + ar[None]]

    def junk(hist, hist_lens):
        return torch.ones((hist.shape[0], k), dtype=torch.int32, device=device)

    modes = [("oracle", oracle), ("junk", junk), ("ngram", None)]
    if args.pattern:
        pattern = [int(x) for x in args.pattern.split(",")]
        tbl = torch.from_numpy(pattern_table(stream, pattern, k, pl,
                                             args.new_tokens)).to(device)

        def realistic(hist, hist_lens):
            return tbl[hist_lens.long().clamp(0, tbl.shape[0] - 1)]
        modes.insert(1, ("pattern", realistic))
    return modes


def run(args, params, lora, cfg, policy, device) -> List[Dict]:
    import torch
    from radialog_tpu_torch.decode.continuous import RingBatcher
    from radialog_tpu_torch.decode.engine import DecodeParams
    from radialog_tpu_torch.decode.spec_ring import SpecCompactBatcher, SpecRingBatcher
    rng = np.random.default_rng(0)
    t, lanes, kk = args.prompt_len, args.lanes, args.k
    prompt = [int(x) for x in rng.integers(3, min(30000, cfg.vocab_size - 1), t)]
    dp = DecodeParams(max_new_tokens=args.new_tokens, eos_token_id=-1)
    preg, cache_p, cache_s = cache_sizes(args)

    def drain(rb):
        sids = [rb.submit(prompt) for _ in range(lanes)]
        finished = rb.run()
        return [finished[s].tokens for s in sids]

    @torch.no_grad()
    def timed(make):
        rb = make()
        toks = drain(rb)                      # warm-up
        best, verifies, secs = float("inf"), 0, []
        for _ in range(args.runs):
            v0 = getattr(rb, "verifies", 0)
            t0 = clock(device)
            toks = drain(rb)
            wall = clock(device) - t0
            secs.append(wall)
            if wall < best:
                best, verifies = wall, getattr(rb, "verifies", 0) - v0
        rb.cache = rb.valid = None            # this mode's cache goes before the next's
        del rb
        free(device)
        return toks, best, verifies, secs

    out, runs_s = {}, {}
    plain_toks, wall, _, runs_s["plain"] = timed(lambda: RingBatcher(
        params, cfg, lanes=lanes, cache_len=cache_p, prompt_len=preg, dp=dp, lora=lora,
        policy=policy, steps_per_call=args.spc_plain, kv_int8=args.kv_int8, device=device))
    total = sum(len(x) for x in plain_toks)
    out["plain"] = {"mode": "plain", "tok_s": round(total / wall, 1),
                    "reports_s": round(lanes / wall, 3), "cache_slots": cache_p}
    if not all(x == plain_toks[0] for x in plain_toks):
        raise AssertionError("same-prompt lanes must decode identical streams")
    stream = np.asarray(plain_toks[0], np.int32)
    spec_cls = SpecCompactBatcher if args.compact else SpecRingBatcher
    for mode, proposer in batch_drafters(stream, args, t, device):
        toks, wall, verifies, runs_s[mode] = timed(lambda p=proposer: spec_cls(
            params, cfg, lanes=lanes, cache_len=cache_s, prompt_len=preg, dp=dp, lora=lora,
            policy=policy, steps_per_call=args.spc_spec, spec_k=kk, spec_m=args.m,
            kv_int8=args.kv_int8, proposer=p, device=device))
        total = sum(len(x) for x in toks)
        exact = sum(a == b for a, b in zip(toks, plain_toks))
        out[mode] = {"mode": mode, "tok_s": round(total / wall, 1),
                     "reports_s": round(lanes / wall, 3),
                     "accepted_per_verify": round(total / max(verifies, 1), 2),
                     "lanes_token_exact_vs_plain": f"{exact}/{lanes}",
                     "cache_slots": cache_s}
    label = device_label(device)
    hdr = {"k": kk, "lanes": lanes, "prompt_len": t, "new_tokens": args.new_tokens,
           "compact": bool(args.compact), "kv_int8": bool(args.kv_int8),
           "spc_plain": args.spc_plain, "spc_spec": args.spc_spec, "note": NOTE,
           "device": label, "runs_s": {k: [round(x, 4) for x in v] for k, v in runs_s.items()}}
    lines = [hdr] + [{**row, "device": label, "runs_s": [round(x, 4) for x in runs_s[m]]}
                     for m, row in out.items()]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


def main(argv: Optional[List[str]] = None, model: Optional[Model] = None,
         params=None) -> List[Dict]:
    """``params``: serving weights to use in place of the tool's own (with
    ``--tiny``, TINY_LLAMA's)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.kv_int8 and not args.compact:
        ap.error("--kv-int8 requires --compact (the ring's interval contract cannot "
                 "encode acceptance holes)")
    if args.tiny:
        from radialog_tpu_torch.models.llama import TINY_LLAMA
        from radialog_tpu_torch.ops.layers import BF16
        dev = open_device("cpu")
        return run(args, params if params is not None else tiny_params(dev), None,
                   TINY_LLAMA, BF16, dev)
    dev = open_device(args.device)
    model = model or full_model()
    models = build_models(model, dev, vision=False)
    return run(args, params if params is not None else models["params"], models["lora"],
               model.llama, policy_of(model), dev)


if __name__ == "__main__":
    main()
