#!/usr/bin/env python3
"""Interactive-serving benchmark of the PyTorch port: ``RingBatcher``
continuous batching at Vicuna-7B serving shapes on one GPU (the port of
tools/bench_interactive.py).

Steady-state aggregate decode throughput with ``--lanes`` concurrent
sessions over W8A8 weights (K1, ``tools/bench_torch.py
build_serving_params``; K4 with ``--w4``) and the bf16 ring cache, or with
``--kv-int8`` the int8 ring, whose decode attention is K2' (K2 with per-lane
slot intervals, csrc/flash_decode.cu). Sessions are admitted staggered, so
the lane mix churns as on a live server; each admission is a batch-1
prefill.

The protocol is the JAX tool's: a warm-up (one session admitted and
stepped, the chunk timed; a second admission timed), the two warm-up
sessions drained, then ``--sessions`` sessions submitted at once and
stepped until every one finished. Each clock read follows
``torch.cuda.synchronize()``. One JSON line: the JAX tool's keys,
``device`` (the card's name and power limit), ``runs_s`` (the steady-state
run's seconds) and ``ignored``: ``--no-donate`` is accepted so that
command lines carry over, but names XLA's buffer donation, which PyTorch
does not have (the ring's cache is written in place either way); it is
listed there when given. ``--device cpu`` runs the kernels' plain
versions, a check of the tool at a tiny model, not a number.

Usage: python3 tools/bench_interactive_torch.py [--lanes 8] [--cache-len 512]
       [--prompt-len 128] [--new-tokens 64] [--sessions 16] [--kv-int8]
       [--w4] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.bench_torch import (Model, build_serving_params, clock, device_label,  # noqa: E402
                               draw_ids, full_model, open_device, policy_of)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=512)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--sessions", type=int, default=16)
    ap.add_argument("--steps-per-call", type=int, default=8,
                    help="decode steps between two admission rounds")
    ap.add_argument("--no-donate", action="store_true",
                    help="accepted for the JAX tool's command lines; no effect here "
                         "(listed under 'ignored')")
    ap.add_argument("--w4", action="store_true", help="W4A8 layer weights (K4)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 ring cache (K2' with per-lane slot intervals)")
    ap.add_argument("--device", default="cuda")
    return ap


def make_batcher(args, params, model: Model, device, cls=None):
    """The tool's RingBatcher (``cls`` in its place, for a caller that
    drives another implementation with the same arguments)."""
    from radialog_tpu_torch.decode.continuous import RingBatcher
    from radialog_tpu_torch.decode.engine import DecodeParams
    prompt_region = -(-args.prompt_len // 32) * 32
    return (cls or RingBatcher)(
        params, model.llama, lanes=args.lanes, cache_len=args.cache_len,
        prompt_len=prompt_region,
        dp=DecodeParams(max_new_tokens=args.new_tokens, eos_token_id=-1),
        policy=policy_of(model), steps_per_call=args.steps_per_call,
        kv_int8=args.kv_int8, device=device)


def drive(rb, args, cfg, device="cpu") -> Dict:
    """The JAX tool's protocol on batcher ``rb``: warm-up, timed chunk and
    admission, drain, then the steady-state run. Returns its seconds and
    token counts, and every finished session's tokens by sid."""
    rng = np.random.default_rng(0)

    def make_prompt():
        return [int(x) for x in draw_ids(rng, cfg, (args.prompt_len,))]

    rb.submit(make_prompt())
    t0 = clock(device)
    rb.step()
    admit_s = clock(device) - t0
    rb.step()
    t0 = clock(device)
    rb.step()
    step_warm = clock(device) - t0
    rb.submit(make_prompt())
    t0 = clock(device)
    rb.step()
    admit_warm_s = clock(device) - t0
    rb.run()
    for _ in range(args.sessions):
        rb.submit(make_prompt())
    done_before = sum(len(s.tokens) for s in rb.finished.values())
    t0 = clock(device)
    steps = 0
    while rb.queue or rb.active_lanes:
        rb.step()
        steps += 1
        if steps > args.sessions * (args.new_tokens + 8):
            raise RuntimeError("scheduler did not drain")
    dt = clock(device) - t0
    total = sum(len(s.tokens) for s in rb.finished.values()) - done_before
    return {"admit_s": admit_s, "step_warm": step_warm, "admit_warm_s": admit_warm_s,
            "dt": dt, "total_tokens": total,
            "tokens": {sid: list(s.tokens) for sid, s in rb.finished.items()}}


def run(args, params, model: Model, device) -> Dict:
    import torch
    with torch.no_grad():
        out = drive(make_batcher(args, params, model, device), args, model.llama, device)
    dt, total = out["dt"], out["total_tokens"]
    line = {"lanes": args.lanes, "sessions": args.sessions,
            "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
            "cache_len": args.cache_len, "steps_per_call": args.steps_per_call,
            "w4": bool(args.w4),
            "aggregate_tok_per_s": round(total / dt, 1),
            "per_session_tok_per_s": round(total / dt / args.lanes, 1),
            "chunk_ms": round(out["step_warm"] * 1000, 2),
            "ms_per_tok": round(out["step_warm"] * 1000 / args.steps_per_call, 2),
            "admit_ms_warm": round(out["admit_warm_s"] * 1000, 1),
            "device": device_label(device), "runs_s": [round(dt, 4)],
            "ignored": ["--no-donate"] if args.no_donate else []}
    print(json.dumps(line), flush=True)
    return line


def main(argv: Optional[List[str]] = None, model: Optional[Model] = None) -> Dict:
    import torch
    args = build_parser().parse_args(argv)
    dev = open_device(args.device)
    model = model or full_model()
    params = build_serving_params(model.llama, torch.Generator(device=dev).manual_seed(0),
                                  bits=4 if args.w4 else 8, device=dev)
    return run(args, params, model, dev)


if __name__ == "__main__":
    main()
