#!/usr/bin/env python3
"""Multi-turn chat latency bench of the PyTorch port: Vicuna-7B, batch 1,
one GPU (the port of tools/bench_chat.py).

Wall time per TURN as a user sees it: append the turn's tokens, then
generate the whole reply. Modes:

  session       ``decode/session.py InteractiveSession``: a persistent bf16
                cache, each turn an incremental prefill of its own tokens
                (through the verify forward) and a cached decode
  session+spec  (``--spec``) the same turns decoded speculatively
                (prompt-lookup drafts, ``generate_spec``); constant weights
                make text whose acceptance says nothing of real text
  reprefill     the reference demo's shape: ``generate`` over the whole
                conversation every turn, on the port's default int8 cache
                (the JAX tool calls its engine with its own default, the
                bf16 cache). From 256 tokens on, the batch-1 prefill runs
                without a cache and its attention is K3
                (csrc/flash_attention.cu), then K2 decodes

Every projection is K1 (``tools/bench_torch.py build_serving_params``'s
constant W8A8 weights). The conversation: a ``--prompt-len``-token report
prompt and a ``--report-tokens`` reply, then ``--turns`` turns of
``--turn-len`` tokens with ``--reply-tokens`` replies. Each mode runs it
twice: the first ("cold") pays cuBLAS plans and the allocator's growth, the
second ("warm") is the steady state. ``--unroll`` is passed to
``DecodeParams`` as in the JAX tool and changes no step here. Each clock
read follows ``torch.cuda.synchronize()``.

Prints the JAX tool's header line, then one line per mode: its keys,
``device`` (the card's name and power limit) and ``runs_s`` (every turn's
seconds, the cold conversation's then the warm one's; empty in the
header). ``--device cpu`` runs the plain versions at a tiny model, a check
of the tool, not a number.

Usage: python3 tools/bench_chat_torch.py [--turns 3] [--spec]
       [--report-tokens 300] [--reply-tokens 64] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.bench_torch import (Model, build_models, clock, device_label, draw_ids,  # noqa: E402
                               full_model, open_device, policy_of)

NOTE = ("cold = conv 1 (cuBLAS plans, the allocator's growth); warm = conv 2 (steady "
        "state). reprefill re-prefills the full history per turn (the reference demo's "
        "shape).")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=3,
                    help="follow-up turns after the report turn")
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--turn-len", type=int, default=24)
    ap.add_argument("--report-tokens", type=int, default=300)
    ap.add_argument("--reply-tokens", type=int, default=64)
    ap.add_argument("--cache-len", type=int, default=1024)
    ap.add_argument("--unroll", type=int, default=1)
    ap.add_argument("--spec", action="store_true")
    ap.add_argument("--spec-k", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    return ap


def conversation(args, cfg, decode_params=None):
    """[(turn ids, DecodeParams)]: the report turn, then the follow-ups,
    drawn as the JAX tool draws them (``decode_params``: another package's
    DecodeParams class in place of the port's)."""
    from radialog_tpu_torch.decode.engine import DecodeParams
    DecodeParams = decode_params or DecodeParams
    rng = np.random.default_rng(0)
    prompt = [int(x) for x in draw_ids(rng, cfg, (args.prompt_len,))]
    turns = [[int(x) for x in draw_ids(rng, cfg, (args.turn_len,))] for _ in range(args.turns)]
    report = DecodeParams(max_new_tokens=args.report_tokens, eos_token_id=-1,
                          unroll=args.unroll)
    reply = DecodeParams(max_new_tokens=args.reply_tokens, eos_token_id=-1,
                         unroll=args.unroll)
    return [(prompt, report)] + [(t, reply) for t in turns]


def run_session(sess, turns, args, spec: bool, device="cpu", convs: int = 2):
    """Each conversation's per-turn seconds, and each turn's reply, on the
    session ``sess`` (anything with ``reset``, ``append_tokens``,
    ``generate`` and ``generate_spec``)."""
    walls, replies = [], []
    for _ in range(convs):
        sess.reset()
        per_turn, outs = [], []
        for ids, dp in turns:
            t0 = clock(device)
            sess.append_tokens(ids)
            out = sess.generate_spec(dp, k=args.spec_k, m=3) if spec else sess.generate(dp)
            per_turn.append(clock(device) - t0)
            assert len(out) == dp.max_new_tokens
            outs.append([int(x) for x in out])
        walls.append(per_turn)
        replies.append(outs)
    return walls, replies


def run_reprefill(models: Dict, model: Model, turns, device, convs: int = 2):
    """The whole history through ``generate`` every turn: per-turn seconds
    and replies of each conversation."""
    import torch
    from radialog_tpu_torch.decode.engine import generate
    from radialog_tpu_torch.decode.kvcache import bucket_length
    walls, replies = [], []
    for _ in range(convs):
        hist, per_turn, outs = [], [], []
        for ids, dp in turns:
            hist = hist + list(ids)
            toks = torch.tensor([hist], dtype=torch.int32, device=device)
            lengths = torch.full((1,), len(hist), dtype=torch.int32, device=device)
            cl = bucket_length(len(hist) + dp.max_new_tokens)
            t0 = clock(device)
            with torch.no_grad():
                res = generate(models["params"], model.llama, toks, lengths, dp,
                               lora=models["lora"], policy=policy_of(model), cache_len=cl)
            new = res.tokens[0, :int(res.lengths[0])].tolist()
            per_turn.append(clock(device) - t0)
            hist = hist + new
            outs.append(new)
        walls.append(per_turn)
        replies.append(outs)
    return walls, replies


def _mode_line(mode: str, walls, args, label: str) -> Dict:
    cold, warm = ([round(x, 3) for x in w] for w in walls)
    return {"mode": mode, "cold_turns_s": cold, "warm_turns_s": warm,
            "warm_followup_mean_s": round(sum(warm[1:]) / max(len(warm) - 1, 1), 3),
            "warm_report_tok_s": round(args.report_tokens / warm[0], 1),
            "device": label, "runs_s": [round(x, 4) for w in walls for x in w]}


def run(args, models: Dict, model: Model, device) -> List[Dict]:
    import torch
    from radialog_tpu_torch.decode.session import InteractiveSession
    label = device_label(device)
    turns = conversation(args, model.llama)
    lines = [{"prompt_len": args.prompt_len, "turn_len": args.turn_len,
              "report_tokens": args.report_tokens, "reply_tokens": args.reply_tokens,
              "turns": 1 + args.turns, "cache_len": args.cache_len, "unroll": args.unroll,
              "note": NOTE, "device": label, "runs_s": []}]
    print(json.dumps(lines[0]), flush=True)

    def session():
        return InteractiveSession(models["params"], model.llama, lora=models["lora"],
                                  policy=policy_of(model), cache_len=args.cache_len,
                                  device=device)
    modes = [("session", False)] + ([("session+spec", True)] if args.spec else [])
    with torch.no_grad():
        for mode, spec in modes:
            walls, _ = run_session(session(), turns, args, spec, device)
            lines.append(_mode_line(mode, walls, args, label))
            print(json.dumps(lines[-1]), flush=True)
    walls, _ = run_reprefill(models, model, turns, device)
    lines.append(_mode_line("reprefill", walls, args, label))
    print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv: Optional[List[str]] = None, model: Optional[Model] = None) -> List[Dict]:
    args = build_parser().parse_args(argv)
    dev = open_device(args.device)
    model = model or full_model()
    return run(args, build_models(model, dev, vision=False), model, dev)


if __name__ == "__main__":
    main()
