#!/usr/bin/env python3
"""Serving-throughput sweep of the PyTorch port: batch x KV-cache dtype x
weight width on one GPU (the port of tools/bench_sweep.py).

Times the pass of tools/bench_torch.py (image -> BioViL-T -> Q-Former ->
Vicuna-7B -> greedy decode with EOS off) at a given batch and cache mode,
one JSON line a run: the JAX tool's keys, the card's name and power limit
(``device``) and each timed pass's seconds (``runs_s``).

  --kv-int8        the int8 token-flat cache (K2); bf16 otherwise
  --w4             W4A8 layer weights (K4) instead of W8A8 (K1); the lm_head
                   stays W8A8
  --shared-prefix  the first P0 prompt tokens prefilled once for the batch
                   (``generate_shared_prefix``); each lane's cache shrinks
                   by P0 slots
  --two-phase      the images embedded apart, then ``generate_two_phase``,
                   which in the port is ``generate``: every call is dispatched
                   on its own and the decode writes the prefill's cache in
                   place, which is what JAX's donated two-program split buys
  --unroll         passed to ``DecodeParams`` as JAX's tool passes it; in the
                   port it changes no step (it spaces the early-exit checks)
  --profile-dir    a torch.profiler trace of the timed passes, written as
                   ``trace.json`` (Chrome format) in that directory (the JAX
                   tool writes an xplane trace)
  --mem            one pass, then the card allocator's figures instead of
                   XLA's ahead-of-time analysis: ``argument_gib`` what was
                   allocated before the pass (weights, inputs), ``output_gib``
                   the result's tensors, ``temp_gib`` the peak above the
                   arguments during the pass, ``peak_gib``
                   ``torch.cuda.max_memory_allocated``. ``alias_gib`` (XLA's
                   donated input-output aliasing) has no counterpart and is
                   printed as null: the cache is written in place

Weights: ``tools/bench_torch.py build_serving_params`` (constant tiles in
the port's (N, K) layout), seeded vision and Q-Former weights. Each pass is
timed with ``torch.cuda.synchronize()`` before the clock is read.
``--device cpu`` runs the kernels' plain versions, a check of the tool at a
tiny model (``main``'s ``model`` argument), not a number.

Usage: python3 tools/bench_sweep_torch.py --batch 16 [--kv-int8] [--w4]
       [--cache-len 448] [--new-tokens 300] [--shared-prefix 48]
       [--profile-dir DIR] [--mem] [--device cuda]
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
                               embed_images, full_model, open_device, policy_of, timed)

GIB = 2 ** 30


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--w4", action="store_true",
                    help="W4A8 layer weights (K4) instead of the default W8A8")
    ap.add_argument("--cache-len", type=int, default=448)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=300)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--unroll", type=int, default=1,
                    help="DecodeParams.unroll, passed through; changes no step here")
    ap.add_argument("--two-phase", action="store_true",
                    help="embed apart, then engine.generate_two_phase (= generate)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="P0",
                    help="the first P0 prompt tokens prefilled once for the batch "
                         "(generate_shared_prefix); the lane cache shrinks by P0 slots")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the timed passes there")
    ap.add_argument("--mem", action="store_true",
                    help="one pass, then the card allocator's figures")
    ap.add_argument("--device", default="cuda")
    return ap


def sweep_inputs(args, model: Model, device) -> Dict:
    """The JAX tool's inputs in its draw order: images, then either the
    shared prefix and the remainders or whole prompts, <IMG> run at 4."""
    import torch
    cfg = model.llama
    rng = np.random.default_rng(0)
    b, p0, s = args.batch, args.shared_prefix, model.image_size
    images = torch.from_numpy(rng.random((b, s, s, 3)).astype(np.float32)).to(device)
    out = {"images": images, "prefix": None}
    if p0:
        out["prefix"] = torch.from_numpy(draw_ids(rng, cfg, (p0,))).to(device)
        t = args.prompt_len - p0
    else:
        t = args.prompt_len
    toks = draw_ids(rng, cfg, (b, t))
    toks[:, 4:4 + cfg.num_img_tokens] = cfg.img_token_id
    out["tokens"] = torch.from_numpy(toks).to(device)
    out["lengths"] = torch.full((b,), t, dtype=torch.int32, device=device)
    return out


def sweep_step(args, models: Dict, model: Model, inputs: Dict, embs=None):
    """The timed pass: embeddings (or ``embs`` given), then
    ``generate_shared_prefix`` with a prefix, else ``generate`` (the same
    function as ``generate_two_phase``)."""
    import torch
    from radialog_tpu_torch.decode import engine
    dp = engine.DecodeParams(max_new_tokens=args.new_tokens, eos_token_id=-1,
                             unroll=args.unroll)
    kw = dict(lora=models["lora"], policy=policy_of(model), kv_int8=args.kv_int8)
    with torch.no_grad():
        if embs is None:
            embs = embed_images(models, model, inputs["images"])
        if inputs["prefix"] is not None:
            return engine.generate_shared_prefix(
                models["params"], model.llama, inputs["prefix"], inputs["tokens"],
                inputs["lengths"], dp, img_embs=embs,
                cache_len=args.cache_len - args.shared_prefix, **kw)
        gen = engine.generate_two_phase if args.two_phase else engine.generate
        return gen(models["params"], model.llama, inputs["tokens"], inputs["lengths"], dp,
                   img_embs=embs, cache_len=args.cache_len, **kw)


def _profiled(run, profile_dir: Optional[str]):
    if not profile_dir:
        return run()
    from torch.profiler import ProfilerActivity, profile
    import torch
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                      else [])
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        out = run()
    prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
    return out


def run(args, models: Dict, model: Model, device) -> Dict:
    """One sweep point on ``models`` (tools/bench_torch.py build_models's
    keys): its JSON line."""
    import torch
    if args.shared_prefix and args.two_phase:
        raise ValueError("--shared-prefix requires the fused path")
    inputs = sweep_inputs(args, model, device)

    def step():
        return sweep_step(args, models, model, inputs)
    cuda = torch.device(device).type == "cuda"
    if args.mem:
        before = torch.cuda.memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = clock(device)
        res = step()
        secs = clock(device) - t0
        out_bytes = sum(t.numel() * t.element_size() for t in (res.tokens, res.lengths))
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        line = {"batch": args.batch, "kv_int8": bool(args.kv_int8),
                "cache_len": args.cache_len,
                "argument_gib": round(before / GIB, 3),
                "output_gib": round(out_bytes / GIB, 6),
                "temp_gib": round((peak - before) / GIB, 3),
                "alias_gib": None,
                "peak_gib": round(peak / GIB, 3),
                "device": device_label(device), "runs_s": [round(secs, 4)]}
        print(json.dumps(line), flush=True)
        return line
    step()                                      # warm-up
    res, runs_s = _profiled(lambda: timed(step, args.runs, device, warm=0), args.profile_dir)
    assert res.tokens.shape == (args.batch, args.new_tokens)
    dt = sum(runs_s)
    line = {"batch": args.batch, "kv_int8": bool(args.kv_int8), "w4": bool(args.w4),
            "two_phase": bool(args.two_phase), "shared_prefix": args.shared_prefix,
            "cache_len": args.cache_len, "new_tokens": args.new_tokens,
            "reports_per_sec": round(args.runs * args.batch / dt, 4),
            "ms_per_token": round(dt / args.runs / args.new_tokens * 1000, 3),
            "device": device_label(device), "runs_s": [round(x, 4) for x in runs_s]}
    print(json.dumps(line), flush=True)
    return line


def main(argv: Optional[List[str]] = None, model: Optional[Model] = None) -> Dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.shared_prefix and args.two_phase:
        ap.error("--shared-prefix requires the fused path")
    dev = open_device(args.device)
    model = model or full_model()
    models = build_models(model, dev, bits=4 if args.w4 else 8)
    return run(args, models, model, dev)


if __name__ == "__main__":
    main()
