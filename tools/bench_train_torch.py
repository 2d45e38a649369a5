#!/usr/bin/env python3
"""One-card training bench of the PyTorch port (the port of
tools/bench_train.py): LoRA finetuning of Vicuna-7B over the int8 frozen
base, or with ``--stage1`` the Q-Former's stage-1 step over raw images.

LoRA (the default): the stacked {"w_q", "scale"} base, every weight a
random int8 drawn on the card (``ops/quant.py random_q8_train_base``, the
port's (K, N) training layout; the JAX tool's constant tiles would make
the gradient cancel at the vocabulary projection), bf16 LoRA and img_proj
gradients, per-layer recomputation, at the reference's training shape
(micro-batch 2, cutoff 600), AdamW 3e-4 (weight decay 1e-4, optax's
default) after a global-norm clip at 1.0, as the JAX tool. With
``--flash`` attention runs K3 (csrc/flash_attention.cu) forward and K5a /
K5b (csrc/flash_attention_bwd.cu) backward; without it, ``mha`` under
autograd.

Stage 1 (``--stage1``, ``--micro`` is the batch): ITC + hard-negative ITM +
LM at BERT-base widths over 448 px images, the frozen BioViL-T trunk inside
the step (``train/steps.py make_stage1_raw_train_step``), 128 text tokens,
AdamW 1e-4; ``--itm-chunks`` splits the 3 x batch ITM forward into that many
chunks (the same losses). No kernel of the port runs there.

One warm-up step per size, then ``--runs`` timed steps, each ended by
``torch.cuda.synchronize()`` before the clock is read; the line keeps the
fastest, as the JAX tool does. One JSON line per size: the JAX tool's keys,
``device`` (the card's name and power limit) and ``runs_s`` (every timed
step's seconds). A size that runs out of card memory prints the JAX tool's
error line (an out-of-memory wall is data); any other exception ends the
run. ``--device cpu`` runs the plain versions at a tiny model, a check of
the tool, not a number.

Usage: python3 tools/bench_train_torch.py [--cutoff 600] [--micro 2 4 8]
       [--runs 3] [--flash] [--stage1 [--itm-chunks 3]] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.bench_torch import (Model, device_label, full_model, open_device,  # noqa: E402
                               policy_of, timed)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cutoff", type=int, default=600)   # the reference's RG cutoff
    ap.add_argument("--micro", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--flash", action="store_true",
                    help="attention through the flash kernels (K3, K5a, K5b)")
    ap.add_argument("--itm-chunks", type=int, default=1,
                    help="(--stage1) the 3x-batch ITM forward in this many chunks")
    ap.add_argument("--stage1", action="store_true",
                    help="the Q-Former stage-1 raw-image step instead of the LoRA step "
                         "(--micro then means batch)")
    ap.add_argument("--device", default="cuda")
    return ap


def _oom_line(head: Dict, e: Exception, device) -> Dict:
    return {**head, "error": type(e).__name__, "detail": str(e)[:200],
            "device": device_label(device), "runs_s": []}


def lora_batch(cfg, mb: int, t: int, rng, device) -> Dict:
    """The JAX tool's micro-batch: random ids with the <IMG> run at 4, the
    first half of every row's labels masked, full lengths, random image
    embeddings in bf16."""
    import torch
    tokens = rng.integers(3, min(30000, cfg.vocab_size - 1), (mb, t)).astype(np.int32)
    tokens[:, 4:4 + cfg.num_img_tokens] = cfg.img_token_id
    labels = tokens.copy()
    labels[:, : t // 2] = -100
    embs = rng.normal(size=(mb, cfg.num_img_tokens, cfg.qformer_dim))
    return {"tokens": torch.from_numpy(tokens).to(device),
            "labels": torch.from_numpy(labels).to(device),
            "lengths": torch.full((mb,), t, dtype=torch.int32, device=device),
            "img_embs": torch.from_numpy(embs).to(device, torch.bfloat16)}


def bench_lora(args, model: Model, device, base=None) -> List[Dict]:
    """The LoRA rows; ``base`` (a ``random_q8_train_base`` tree) is built
    here unless given."""
    import torch
    from radialog_tpu_torch.models.llama import lora_init
    from radialog_tpu_torch.ops.quant import random_q8_train_base
    from radialog_tpu_torch.train.optim import make_adamw
    from radialog_tpu_torch.train.steps import TrainState, make_lora_train_step
    cfg = model.llama
    if base is None:
        base = random_q8_train_base(cfg, torch.Generator(device=device).manual_seed(1),
                                    device=device)
    lora = lora_init(torch.Generator(device=device).manual_seed(0), cfg, device=device,
                     dtype=torch.bfloat16)
    tx = make_adamw(3e-4, weight_decay=1e-4, grad_clip=1.0)
    step_fn = make_lora_train_step(tx, cfg, policy=policy_of(model), remat=True,
                                   flash=args.flash)
    rng = np.random.default_rng(0)
    t, lines = args.cutoff, []
    for mb in args.micro:
        batch = lora_batch(cfg, mb, t, rng, device)
        head = {"micro_batch": mb, "cutoff": t}
        try:
            state = [TrainState.create(_flat_copy(lora), tx)]

            def step():
                state[0], metrics = step_fn(state[0], base, batch)
                return metrics
            metrics, secs = timed(step, args.runs, device)
            best = min(secs)
            line = {**head, "ms_per_step": round(1e3 * best, 1),
                    "tokens_per_sec": round(mb * t / best, 1),
                    "loss": round(float(metrics["loss"]), 4),
                    "grad_norm": float(metrics["grad_norm"]),
                    "device": device_label(device), "runs_s": [round(x, 4) for x in secs]}
        except torch.cuda.OutOfMemoryError as e:
            line = _oom_line(head, e, device)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def _flat_copy(tree):
    """A copy of a parameter tree (dicts of tensors) for a fresh state."""
    import torch
    if isinstance(tree, dict):
        return {k: _flat_copy(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree


def stage1_setup(model: Model, device):
    """(cfg, stage-1 params without the trunk, trunk params, trunk state):
    ``blip2_init`` at the model's widths from a generator seeded 0."""
    import dataclasses
    import torch
    from radialog_tpu_torch.models.biovil_t import biovil_t_init
    from radialog_tpu_torch.models.blip2 import blip2_init
    cfg = dataclasses.replace(model.blip2, image_size=model.image_size)
    gen = torch.Generator(device=device).manual_seed(0)
    params, state = blip2_init(gen, cfg, device, with_vision=False)
    visual, vstate = biovil_t_init(gen, device, joint_feature_size=cfg.qformer.encoder_width,
                                   resnet_layers=model.resnet_layers,
                                   bottleneck=model.bottleneck)
    return cfg, params, visual, vstate


def bench_stage1(args, model: Model, device, setup=None) -> List[Dict]:
    """The stage-1 rows (``setup``: ``stage1_setup``'s tuple, built here
    unless given)."""
    import torch
    from radialog_tpu_torch.train.optim import make_adamw
    from radialog_tpu_torch.train.steps import TrainState, make_stage1_raw_train_step
    cfg, params, visual, vstate = setup or stage1_setup(model, device)
    tx = make_adamw(1e-4, weight_decay=1e-4)
    step_fn = make_stage1_raw_train_step(tx, cfg, policy=policy_of(model),
                                         itm_chunks=args.itm_chunks)
    rng = np.random.default_rng(0)
    t = min(128, cfg.qformer.bert.max_position)
    vocab = cfg.qformer.bert.vocab_size
    s = model.image_size
    lines = []
    for mb in args.micro:
        images = torch.from_numpy(rng.random((mb, s, s, 3)).astype(np.float32)).to(device)
        ids = rng.integers(106, min(30000, vocab - 1), (mb, t)).astype(np.int32)
        ids[:, 0] = 101     # [CLS]
        batch = {"images": images, "text_ids": torch.from_numpy(ids).to(device),
                 "text_mask": torch.ones((mb, t), dtype=torch.int32, device=device)}
        head = {"mode": "stage1", "batch": mb}
        try:
            state = [TrainState.create(_flat_copy(params), tx)]

            def step():
                gen = torch.Generator(device=device).manual_seed(0)   # one key, as JAX's
                state[0], metrics = step_fn(state[0], visual, vstate, batch, gen)
                return metrics
            m, secs = timed(step, args.runs, device)
            best = min(secs)
            line = {**head, "ms_per_step": round(1e3 * best, 1),
                    "images_per_sec": round(mb / best, 1),
                    **{k: round(float(m[k]), 4) for k in ("loss", "loss_itc", "loss_itm",
                                                           "loss_lm")},
                    "device": device_label(device), "runs_s": [round(x, 4) for x in secs]}
        except torch.cuda.OutOfMemoryError as e:
            line = _oom_line(head, e, device)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv: Optional[List[str]] = None, model: Optional[Model] = None) -> List[Dict]:
    args = build_parser().parse_args(argv)
    dev = open_device(args.device)
    model = model or full_model()
    if args.stage1:
        return bench_stage1(args, model, dev)
    return bench_lora(args, model, dev)


if __name__ == "__main__":
    main()
