#!/usr/bin/env python3
"""Tensor-parallel serving across cards: chip_smoke.py's tp phase with its
ranks on cards of their own, NCCL between them.

Three groups, one after the other, each running the phase's cases (the
int8 cache with a shared prefix, the same with in-kernel KV writes, beams
over the bf16 cache, RaDialogServer over TPRingBatcher, W4A8 shards) and
held by ``chip_smoke.phase_tp`` against the same weights unsharded on card
0 (each case within the quantized weights' own error; every rank's tokens
and ring chunks equal; K1-K4 launched at the shard's shapes and held
against their plain versions): gloo at TP = 2 on two cards, NCCL at TP = 2
on two cards, NCCL at TP = 4 on four. Then NCCL's TP = 2 tokens must equal
gloo's bit for bit (two partials sum alike in any order). The W4A8
reference is measure_quant's seed-0 layer, packed here.

Needs four cards and a checkout of the repository:
``python3 tools/tp_cards_torch.py``; prints chip_smoke's tp lines, then one
JSON line; exits non-zero if a check fails.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CASES = ("int8_prefix", "defer", "beam", "ring", "w4")
GROUPS = (("gloo2", 2, "gloo"), ("nccl2", 2, "nccl"), ("nccl4", 4, "nccl"))


def main() -> int:
    import numpy as np
    import torch
    if torch.cuda.device_count() < 4:
        print("tp_cards_torch: needs four CUDA cards", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    import chip_smoke as cs
    from radialog_tpu_torch.models.llama import llama_init
    from radialog_tpu_torch.ops import _build
    from radialog_tpu_torch.ops.layers import set_precision
    from tools import measure_quant_torch as mq
    print(cs.smi(), torch.__version__, "cards", torch.cuda.device_count(), flush=True)
    t0 = time.time()
    _build.build()          # before any rank starts: no two ranks build at once
    set_precision()
    cfg1 = cs._tp_cfg(cs.QUALITY_W4_LAYERS)
    params32 = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg1, device="cuda")
    toks = np.random.default_rng(0).integers(3, 30000, (8, 64)).astype(np.int32)
    kept = {}
    w4_err = mq.measure_seed(params32, cfg1, torch.from_numpy(toks).cuda(),
                             torch.full((8,), 64, dtype=torch.int32, device="cuda"), 1,
                             [("w4a8-asym", 4, "asym")], 64 + 1 + 14,
                             lambda name, p: kept.__setitem__("w4", p))["w4a8-asym"][0]
    del params32
    failed = []
    for name, world, backend in GROUPS:
        started = {"gloo": cs._tp_start(name, world, backend, CASES),
                   "nccl1": cs._tp_start(f"{name}_one", 1, "nccl", ("int8_prefix",))}
        try:
            cs.phase_tp(torch, started, {"w4_err": w4_err}, kept["w4"])
        except AssertionError as exc:
            print(f"{name}: {exc}", file=sys.stderr, flush=True)
            failed.append(name)
        finally:
            for _, procs in started.values():
                for p, log in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                    log.close()
    tokens = {}
    for name in ("gloo2", "nccl2"):
        with open(ROOT / "build" / "tp" / f"{name}.json.0.json") as f:
            tokens[name] = json.load(f)["cases"]
    equal = {c: tokens["gloo2"][c].get("tokens", tokens["gloo2"][c].get("served"))
             == tokens["nccl2"][c].get("tokens", tokens["nccl2"][c].get("served")) for c in CASES}
    ok = not failed and all(equal.values())
    print(json.dumps({"groups": [g[0] for g in GROUPS], "failed": failed,
                      "nccl2_tokens_equal_gloo2": equal, "w4a8_err": w4_err,
                      "seconds": time.time() - t0, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
