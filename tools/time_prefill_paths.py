#!/usr/bin/env python3
"""The two prefill paths of the PyTorch port's engine, timed on one GPU.

Run from the repository root: ``python3 tools/time_prefill_paths.py``
(it builds the kernels first if needed). ``decode.engine.prefill`` writes
the prompt's K/V straight into the int8 cache at batch >=
DIRECT_PREFILL_MIN_BATCH (30, the JAX engine's rule) and below it prefills
without a cache (K3 at T >= 256) and then quantizes the fresh K/V into the
cache (``install_prefill``). This script forces each path in turn on the
full-width synthetic Vicuna-7B W8A8 model of ``chip_smoke.py`` and prints
one JSON line per (prompt length, batch): the median host-clock time of
the whole call (ended by a synchronize) over REPEATS calls after a
warm-up, the two paths taking turns so that a drift of the host clock
falls on both, and the peak device memory above the weights of each.
The last line names, for each prompt length, the batches at which the
direct path is faster. It needs one CUDA card and exits non-zero
without one.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

LENGTHS = (128, 436)               # the report prompt; the batch-1 follow-up
BATCHES = (1, 4, 14, 30, 56)
NEW_TOKENS, REPEATS = 300, 7


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_prefill_paths: no CUDA device", file=sys.stderr)
        return 2
    from radialog_tpu_torch.apps.pipeline import PipelineConfig, RaDialogPipeline
    from radialog_tpu_torch.decode import engine as te
    from radialog_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    _build.build()
    pipe = RaDialogPipeline(PipelineConfig(synthetic=True, seed=0))
    cfg = pipe.llama_cfg
    g = torch.Generator(device="cuda").manual_seed(11)
    rule = te.DIRECT_PREFILL_MIN_BATCH
    thresholds = {"direct": 0, "cache_free": 1 << 30}
    direct_faster = {t: [] for t in LENGTHS}
    try:
        for t in LENGTHS:
            for b in BATCHES:
                tok = torch.randint(3, cfg.img_token_id, (b, t), generator=g, device="cuda",
                                    dtype=torch.int32)
                lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
                cache_len = te.bucket_length(t + NEW_TOKENS)
                row = {}

                def call(path):
                    te.DIRECT_PREFILL_MIN_BATCH = thresholds[path]
                    return te.prefill(pipe.llama, cfg, tok, lens, cache_len,
                                      lora=pipe.lora, policy=pipe.policy)

                times = {path: [] for path in thresholds}
                for path in thresholds:                       # warm-up and peak memory
                    call(path)
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    call(path)
                    torch.cuda.synchronize()
                    row[f"{path}_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
                for _ in range(REPEATS):
                    for path in thresholds:
                        t0 = time.perf_counter()
                        call(path)
                        torch.cuda.synchronize()
                        times[path].append((time.perf_counter() - t0) * 1e3)
                for path in thresholds:
                    row[f"{path}_ms"] = statistics.median(times[path])
                    row[f"{path}_ms_all"] = times[path]
                emit("prefill", card=card, prompt=t, batch=b, repeats=REPEATS,
                     cache_len=cache_len, **row)
                if row["direct_ms"] < row["cache_free_ms"]:
                    direct_faster[t].append(b)
    finally:
        te.DIRECT_PREFILL_MIN_BATCH = rule
    emit("crossover", card=card, rule=rule, batches=list(BATCHES),
         direct_faster_at_batches={str(t): v for t, v in direct_faster.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
