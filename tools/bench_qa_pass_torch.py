#!/usr/bin/env python3
"""The binary-QA serving shape on one GPU (the PyTorch port of
tools/bench_qa_pass.py; test.py's binary-QA pass): 14 yes/no questions
about ONE study, each prompt a ``--hist-len``-token conversation history
(with the 32-token <IMG> run) and a ``--q-len``-token question, 10 new
tokens.

Two passes over the same prompts, each the engine call the JAX tool times:

  plain   ``generate``: every lane prefills the whole history and its
          question; at 14 lanes (below the engine's direct-prefill batch)
          the prefill runs without a cache, so its attention is K3
          (csrc/flash_attention.cu) over 464 tokens, then K2 decodes
  shared  ``generate_shared_prefix`` with the image in the prefix
          (``prefix_img_embs``): the history is prefilled once (K3 over 448
          tokens), each lane's cache holds only its question and answer,
          and K2 reads the prefix once a step for every lane

Every projection is K1 (W8A8, ``tools/bench_torch.py
build_serving_params``'s constant weights). One warm-up call, then
``--runs`` timed ones, each ended by ``torch.cuda.synchronize()`` before
the clock is read. One JSON line: the JAX tool's keys (mean seconds a
study), the card's name and power limit (``device``) and each timed call's
seconds by pass (``runs_s``). ``--device cpu`` runs the kernels' plain
versions, a check of the tool at a tiny model, not a number.

Usage: python3 tools/bench_qa_pass_torch.py [--hist-len 448] [--q-len 16]
       [--no-kv-int8] [--device cuda]
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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hist-len", type=int, default=448,
                    help="shared history tokens (prompt + generated report)")
    ap.add_argument("--q-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=10)   # test.py's
    ap.add_argument("--batch", type=int, default=14)        # 14 findings
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--kv-int8", action=argparse.BooleanOptionalAction, default=True,
                    help="--no-kv-int8 measures the bf16 cache")
    ap.add_argument("--device", default="cuda")
    return ap


def qa_inputs(args, cfg, device) -> Dict:
    """The JAX tool's draws: the history (<IMG> run at 4), the questions,
    one study's image embeddings."""
    import torch
    rng = np.random.default_rng(0)
    hist = draw_ids(rng, cfg, (args.hist_len,))
    hist[4:4 + cfg.num_img_tokens] = cfg.img_token_id
    qs = draw_ids(rng, cfg, (args.batch, args.q_len))
    emb1 = rng.normal(size=(1, cfg.num_img_tokens, cfg.qformer_dim)).astype(np.float32)
    return {"hist": hist, "qs": qs, "emb1": torch.from_numpy(emb1).to(device)}


def qa_passes(args, models: Dict, model: Model, inputs: Dict, device):
    """{"plain": fn, "shared": fn}: each runs its pass once and returns
    the engine's GenerationResult."""
    import torch
    from radialog_tpu_torch.decode import engine
    cfg, b, h, q = model.llama, args.batch, args.hist_len, args.q_len
    dp = engine.DecodeParams(max_new_tokens=args.new_tokens, eos_token_id=-1)
    kw = dict(lora=models["lora"], policy=policy_of(model), kv_int8=args.kv_int8)
    full = torch.from_numpy(np.concatenate([np.tile(inputs["hist"][None], (b, 1)),
                                            inputs["qs"]], axis=1)).to(device)
    lens = torch.full((b,), h + q, dtype=torch.int32, device=device)
    plain_cache = -(-(h + q + args.new_tokens) // 32) * 32
    lane_cache = -(-(q + args.new_tokens) // 32) * 32
    hist = torch.from_numpy(inputs["hist"]).to(device)
    qs = torch.from_numpy(inputs["qs"]).to(device)
    qlens = torch.full((b,), q, dtype=torch.int32, device=device)
    emb1 = inputs["emb1"]

    @torch.no_grad()
    def plain():
        return engine.generate(models["params"], cfg, full, lens, dp,
                               img_embs=emb1.expand(b, -1, -1), cache_len=plain_cache, **kw)

    @torch.no_grad()
    def shared():
        return engine.generate_shared_prefix(models["params"], cfg, hist, qs, qlens, dp,
                                             prefix_img_embs=emb1, cache_len=lane_cache, **kw)
    return {"plain": plain, "shared": shared}


def run(args, models: Dict, model: Model, device) -> Dict:
    fns = qa_passes(args, models, model, qa_inputs(args, model.llama, device), device)
    runs_s = {}
    for name, fn in fns.items():
        res, runs_s[name] = timed(fn, args.runs, device)
        assert res.tokens.shape == (args.batch, args.new_tokens)
    t_plain = sum(runs_s["plain"]) / args.runs
    t_shared = sum(runs_s["shared"]) / args.runs
    line = {"batch": args.batch, "hist_len": args.hist_len, "q_len": args.q_len,
            "new_tokens": args.new_tokens, "kv_int8": bool(args.kv_int8),
            "plain_s_per_study": round(t_plain, 4),
            "shared_s_per_study": round(t_shared, 4),
            "speedup": round(t_plain / t_shared, 2),
            "device": device_label(device),
            "runs_s": {k: [round(x, 4) for x in v] for k, v in runs_s.items()}}
    print(json.dumps(line), flush=True)
    return line


def main(argv: Optional[List[str]] = None, model: Optional[Model] = None) -> Dict:
    args = build_parser().parse_args(argv)
    dev = open_device(args.device)
    model = model or full_model()
    return run(args, build_models(model, dev, vision=False), model, dev)


if __name__ == "__main__":
    main()
