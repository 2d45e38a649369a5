#!/usr/bin/env python3
"""The all-findings-QA serving shape on one GPU (the PyTorch port of
tools/bench_allqa_pass.py; test.py's all-QA pass): "List all the findings"
over batches of DISTINCT studies, batch 5, 30 new tokens.

Every lane carries another image, so only the 48-token boilerplate before
the <IMG> run is shared (apps/pipeline.py ``_shared_prefix_len``). Two
passes over the same prompts, each the engine call the JAX tool times:

  plain   ``generate``: each lane prefills its whole history and question
          (at batch 5 without a cache: K3, csrc/flash_attention.cu, over
          464 tokens), then K2 decodes
  shared  ``generate_shared_prefix`` with the 48-token prefix prefilled
          once (the pipeline's default for such a batch)

Every projection is K1 (W8A8, ``tools/bench_torch.py
build_serving_params``). One warm-up call, then ``--runs`` timed ones, each
ended by ``torch.cuda.synchronize()`` before the clock is read. One JSON
line: the JAX tool's keys, the card's name and power limit (``device``) and
each timed call's seconds by pass (``runs_s``). ``--device cpu`` runs the
kernels' plain versions, a check of the tool at a tiny model, not a number.

Usage: python3 tools/bench_allqa_pass_torch.py [--hist-len 448] [--batch 5]
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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hist-len", type=int, default=448,
                    help="per-study tokens: prompt + generated report")
    ap.add_argument("--q-len", type=int, default=16,
                    help="'List all the findings...' turn")
    ap.add_argument("--new-tokens", type=int, default=30)   # test.py's
    ap.add_argument("--batch", type=int, default=5)         # test.py's
    ap.add_argument("--prefix", type=int, default=48,
                    help="shared boilerplate tokens before the <IMG> run")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--kv-int8", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--device", default="cuda")
    return ap


def allqa_inputs(args, cfg, device) -> Dict:
    """The JAX tool's draws: the prefix, each lane's own history and
    question (<IMG> run at 2), each study's image embeddings."""
    import torch
    rng = np.random.default_rng(0)
    b, h, q, p0 = args.batch, args.hist_len, args.q_len, args.prefix
    prefix = draw_ids(rng, cfg, (p0,))
    rem = draw_ids(rng, cfg, (b, h - p0 + q))
    rem[:, 2:2 + cfg.num_img_tokens] = cfg.img_token_id
    embs = rng.normal(size=(b, cfg.num_img_tokens, cfg.qformer_dim)).astype(np.float32)
    return {"prefix": prefix, "rem": rem, "embs": torch.from_numpy(embs).to(device)}


def allqa_passes(args, models: Dict, model: Model, inputs: Dict, device):
    """{"plain": fn, "shared": fn}, each returning the GenerationResult."""
    import torch
    from radialog_tpu_torch.decode import engine
    cfg, b, h, q, p0 = model.llama, args.batch, args.hist_len, args.q_len, args.prefix
    dp = engine.DecodeParams(max_new_tokens=args.new_tokens, eos_token_id=-1)
    kw = dict(lora=models["lora"], policy=policy_of(model), kv_int8=args.kv_int8)
    full = torch.from_numpy(np.concatenate([np.tile(inputs["prefix"][None], (b, 1)),
                                            inputs["rem"]], axis=1)).to(device)
    lens = torch.full((b,), h + q, dtype=torch.int32, device=device)
    plain_cache = -(-(h + q + args.new_tokens) // 32) * 32
    lane_cache = -(-(h - p0 + q + args.new_tokens) // 32) * 32
    prefix = torch.from_numpy(inputs["prefix"]).to(device)
    rem = torch.from_numpy(inputs["rem"]).to(device)
    rlens = torch.full((b,), h - p0 + q, dtype=torch.int32, device=device)

    @torch.no_grad()
    def plain():
        return engine.generate(models["params"], cfg, full, lens, dp, img_embs=inputs["embs"],
                               cache_len=plain_cache, **kw)

    @torch.no_grad()
    def shared():
        return engine.generate_shared_prefix(models["params"], cfg, prefix, rem, rlens, dp,
                                             img_embs=inputs["embs"], cache_len=lane_cache,
                                             **kw)
    return {"plain": plain, "shared": shared}


def run(args, models: Dict, model: Model, device) -> Dict:
    fns = allqa_passes(args, models, model, allqa_inputs(args, model.llama, device), device)
    runs_s = {}
    for name, fn in fns.items():
        res, runs_s[name] = timed(fn, args.runs, device)
        assert res.tokens.shape == (args.batch, args.new_tokens)
    t_plain = sum(runs_s["plain"]) / args.runs
    t_shared = sum(runs_s["shared"]) / args.runs
    b = args.batch
    line = {"batch": b, "hist_len": args.hist_len, "q_len": args.q_len,
            "prefix": args.prefix, "new_tokens": args.new_tokens,
            "kv_int8": bool(args.kv_int8),
            "plain_s_per_batch": round(t_plain, 4), "shared_s_per_batch": round(t_shared, 4),
            "plain_s_per_study": round(t_plain / b, 4),
            "shared_s_per_study": round(t_shared / b, 4),
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
