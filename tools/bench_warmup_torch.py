#!/usr/bin/env python3
"""Boot-time measurement of the PyTorch port: what a fresh process pays
before its first user's turn, Vicuna-7B on one GPU (the port of
tools/bench_warmup.py).

In this process, after the imports: ``weights_s`` makes the CUDA context
and the synthetic serving weights (``tools/bench_torch.py
build_serving_params``'s constant W8A8 tiles, K1 in every projection and
the lm_head) and bf16 LoRA; ``warmup_s`` runs ``InteractiveSession.warmup``
(a throwaway 128-token turn and a ``--max-new``-token reply over the bf16
session cache, with ``--spec`` also the speculative loop at k = 5), which
builds each kernel the session's path loads (nvcc, at first use) and makes
cuBLAS's plans and the allocator's pool; ``first_turn_s`` is the first
real turn after it: 120 token ids appended and a ``--max-new``-token
reply. Each clock read follows ``torch.cuda.synchronize()``.

``--cache-dir`` is the kernels' build directory (``ops/_build.py
set_build_dir``), the port's counterpart of JAX's compilation cache: an
empty directory is a true cold boot (nvcc builds the libraries into it),
the default one, already built, the warm boot of a redeploy. The JAX
tool's default names its ``.jax_cache``; this one defaults to the build
directory's own default, ``build/kernels`` at the repository root.

Prints one JSON line: the JAX tool's keys (``weights_s``, ``warmup_s``,
``first_turn_s``, ``tokens``, ``cache_dir``, rounded as it rounds them) and
``device`` (the card's name and power limit). ``--device cpu`` runs the
kernels' plain versions at a tiny model (``main``'s ``model`` argument), a
check of the tool, not a number.

Usage: python3 tools/bench_warmup_torch.py [--spec] [--cache-dir DIR]
       [--max-new 300] [--cache-len 1024] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from radialog_tpu_torch.ops import _build  # noqa: E402
from tools.bench_torch import (Model, build_serving_params, clock, device_label,  # noqa: E402
                               full_model, open_device, policy_of)

WARMUP_TURN, FIRST_TURN, SPEC_K = 128, 120, 5   # the JAX tool's


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache-dir", default=str(_build.DEFAULT_BUILD_DIR),
                    help="the kernels' build directory (empty: a cold boot)")
    ap.add_argument("--spec", action="store_true",
                    help="also warm the speculative loop (k=5)")
    ap.add_argument("--max-new", type=int, default=300)
    ap.add_argument("--cache-len", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    return ap


def boot(model: Model, device):
    """The serving weights and LoRA from one generator seeded 0 (bf16 LoRA,
    f32 at a float policy)."""
    import torch
    from radialog_tpu_torch.models.llama import lora_init
    gen = torch.Generator(device=device).manual_seed(0)
    params = build_serving_params(model.llama, gen, device=device)
    lora = lora_init(gen, model.llama, device=device,
                     dtype=torch.bfloat16 if model.bf16 else torch.float32)
    return params, lora


def decode_params(args):
    from radialog_tpu_torch.decode.engine import DecodeParams
    return DecodeParams(max_new_tokens=args.max_new, eos_token_id=-1)


def warm(sess, args) -> None:
    """The JAX tool's warm-up: one 128-token turn, its reply (and with
    ``--spec`` the speculative loop first), then a reset."""
    sess.warmup(decode_params(args), turn_lengths=(WARMUP_TURN,),
                spec_k=SPEC_K if args.spec else 0)


def first_turn(sess, args, cfg) -> List[int]:
    """The first real turn: the JAX tool's 120 ids, then the reply."""
    ids = np.random.default_rng(0).integers(3, min(30000, cfg.vocab_size), FIRST_TURN)
    sess.append_tokens([int(x) for x in ids])
    return sess.generate(decode_params(args))


def main(argv: Optional[List[str]] = None, model: Optional[Model] = None) -> Dict:
    from radialog_tpu_torch.decode.session import InteractiveSession
    args = build_parser().parse_args(argv)
    _build.set_build_dir(args.cache_dir)          # before any kernel can load
    dev = open_device(args.device)
    model = model or full_model()
    t0 = time.perf_counter()        # nothing is queued yet: the CUDA context is made inside
    params, lora = boot(model, dev)
    weights_s = clock(dev) - t0
    sess = InteractiveSession(params, model.llama, lora=lora, policy=policy_of(model),
                              cache_len=args.cache_len, device=dev)
    t0 = clock(dev)
    warm(sess, args)
    warmup_s = clock(dev) - t0
    t0 = clock(dev)
    out = first_turn(sess, args, model.llama)
    first_turn_s = clock(dev) - t0
    line = {"weights_s": round(weights_s, 1), "warmup_s": round(warmup_s, 1),
            "first_turn_s": round(first_turn_s, 2), "tokens": len(out),
            "cache_dir": args.cache_dir, "device": device_label(dev)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
