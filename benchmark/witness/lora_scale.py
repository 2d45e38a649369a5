#!/usr/bin/env python3
"""Witness of the program fault that keeps the LoRA finetune out of the
benchmark: the port's LoRA tree trains its ``scale`` leaf (alpha / r, a 0-d
tensor that ``llama_apply`` multiplies through), which RaDialog's LoRA
(PEFT, ``LoraLayer.scaling``, a Python float) holds constant.

    python3 benchmark/witness/lora_scale.py --seeds 1,2,3
    python3 benchmark/witness/lora_scale.py --seeds 1,2,3 --cpu-tiny

It builds the step as ``apps/finetune_lora.py`` composes it
(``make_lora_train_step``, ``make_adamw`` at 3e-4 after a clip at 1.0, no
decay) on the configuration's widths (``deepseek-llm-7b.w8a8``; the tiny
sizes of ``benchmark/tests/tiny.json`` with ``--cpu-tiny``): an int8 frozen
base (``ops/quant.py random_q8_train_base``), ``lora_init``, bf16 with
per-layer recomputation, flash attention on the card. It runs three
updates at accumulation 1, each on a micro-batch of two rows drawn from the
seed (``--rows`` tokens, the first half the prompt, 32 <IMG> slots with
image queries), and prints one JSON line a seed: the scale before and
after each update.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def batch(lcfg, config, rows: int, gen, device):
    import torch
    from radialog_tpu_torch.train.steps import IGNORE_INDEX
    lo, hi = config["text_token_range"]
    n_img = lcfg.num_img_tokens
    tokens = torch.randint(lo, hi, (2, rows), generator=gen, device=device)
    tokens[:, 4:4 + n_img] = lcfg.img_token_id
    lengths = torch.tensor([rows, rows - rows // 4], device=device)
    labels = tokens.clone()
    labels[:, :rows // 2] = IGNORE_INDEX
    labels[1, int(lengths[1]):] = IGNORE_INDEX
    imgs = torch.randn((2, n_img, lcfg.qformer_dim), generator=gen, device=device)
    return {"tokens": tokens.int(), "labels": labels.int(), "lengths": lengths.int(),
            "img_embs": imgs.to(torch.bfloat16)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--config", default="deepseek-llm-7b.w8a8")
    ap.add_argument("--rows", type=int, default=600)
    ap.add_argument("--cpu-tiny", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import port
    from radialog_tpu_torch.models.llama import lora_init
    from radialog_tpu_torch.ops import _build
    from radialog_tpu_torch.ops.layers import BF16, set_precision
    from radialog_tpu_torch.ops.quant import random_q8_train_base
    from radialog_tpu_torch.train.optim import make_adamw
    from radialog_tpu_torch.train.steps import TrainState, make_lora_train_step
    _build.set_build_dir(ROOT / "build" / "kernels")
    config = json.loads((ROOT / "benchmark" / "configs" / f"{args.config}.json").read_text())
    rows = args.rows
    if args.cpu_tiny:
        tiny = json.loads((ROOT / "benchmark" / "tests" / "tiny.json").read_text())
        config = dict(config, **tiny["config"][config["path"]["weights"]])
        rows = min(rows, 64)
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("needs a CUDA device (or --cpu-tiny)", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        set_precision()
    lcfg = port.llama_config(config)
    lora_cfg = config["lora"]
    for seed in (int(s) for s in args.seeds.split(",")):
        gen = torch.Generator(device=device).manual_seed(seed)
        base = random_q8_train_base(lcfg, gen, device=device)
        lora = lora_init(gen, lcfg, device=device, rank=lora_cfg["rank"],
                         alpha=lora_cfg["alpha"], targets=tuple(lora_cfg["targets"]))
        tx = make_adamw(3e-4, weight_decay=0.0, grad_clip=1.0)
        step = make_lora_train_step(tx, lcfg, policy=BF16, remat=True,
                                    flash=device.type == "cuda")
        state = TrainState.create(lora, tx)
        before = float(state.params["scale"])
        after = []
        for _ in range(3):
            state, _metrics = step(state, base, batch(lcfg, config, rows, gen, device))
            after.append(float(state.params["scale"]))
        print(json.dumps({"device": device.type, "config": args.config, "seed": seed,
                          "rows": rows, "scale_before": before,
                          "scale_after_each_update": after}), flush=True)
        del base, lora, state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
