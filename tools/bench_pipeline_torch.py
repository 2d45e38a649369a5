#!/usr/bin/env python3
"""The composed stage-1 input pipeline of the PyTorch port, sustained (the
port of tools/bench_pipeline.py):

    CxrLoader(threads) -> stage1_raw_batches (decode + resize 512 + crop
    448 + caption tokenize/pad) -> DevicePrefetcher(depth) -> the stage-1
    step (``train/steps.py make_stage1_raw_train_step``, the frozen
    ResNet-50 inside)

for ``--steps`` steps on one GPU: the sustained images/s with host decode,
tokenization, pinned host-to-card staging and the device step sharing the
host. ``native/loader.py`` takes its C++ route where g++ and libjpeg are
found, else its PIL route (``CxrLoader.route``); the card's machine has no
libjpeg, so there it is PIL. Captions go through the whitespace tokenizer.
The stage-1 step launches none of the port's kernels.

The JPEG corpus is written first (``--imgs`` synthetic 512 px gradients
with noise, so the decoder does real work) in a temporary directory that
is removed at the end. ``--no-step`` feeds and stages only; ``--no-prefetch``
runs the serial loop (next batch, copy, step) without the prefetcher's
thread. ``--tiny``: TINY_QFORMER, a one-block ResNet, 96 px images cropped
to 64, on the CPU whatever ``--device`` says, as in the JAX tool: a check of
the protocol, not a number.

Each step's clock read follows ``torch.cuda.synchronize()``, so the
per-step times are the device's too (the prefetcher's thread still stages
the next batches meanwhile). One JSON line: the JAX tool's keys,
``device`` (the card's name and power limit) and ``runs_s`` (every step's
seconds).

Usage: python3 tools/bench_pipeline_torch.py [--batch 32] [--steps 50]
       [--threads 2] [--depth 2] [--imgs 96] [--tiny] [--no-step]
       [--no-prefetch] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.bench_torch import clock, device_label, open_device  # noqa: E402

NOTE = ("sustained: host decode + tokenize + pinned H2D staging + device step, the "
        "clock read after each step's synchronize")
CAPTIONS = ["lungs are clear with no pleural effusion or pneumothorax",
            "mild cardiomegaly with pulmonary vascular congestion",
            "right basilar opacity concerning for pneumonia",
            "no acute cardiopulmonary process identified today"]


class _Records:
    """A fixed record list (img_path + caption) in Stage1Data's interface;
    a custom epoch is the identity (one synthetic epoch is streamed)."""

    def __init__(self, recs):
        self._recs = recs

    def set_custom_epoch(self, _sub):
        pass

    def __len__(self):
        return len(self._recs)

    def __getitem__(self, i):
        return self._recs[i]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--imgs", type=int, default=96,
                    help="unique synthetic 512^2 JPEGs (paths repeat to fill the epoch)")
    ap.add_argument("--max-txt-len", type=int, default=128)
    ap.add_argument("--tiny", action="store_true",
                    help="TINY models on the CPU: a protocol check, not a number")
    ap.add_argument("--no-step", action="store_true",
                    help="feed and stage only (skip the train step)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="serial loop without the DevicePrefetcher thread")
    ap.add_argument("--device", default="cuda")
    return ap


def write_corpus(root: Path, n: int, side: int) -> List[str]:
    """n synthetic grayscale JPEGs (gradients + noise, quality 90)."""
    from PIL import Image
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        g = np.linspace(0, 255, side, dtype=np.float32)
        img = (g[None, :] * 0.5 + g[:, None] * 0.5
               + rng.normal(0, 24, (side, side))).clip(0, 255).astype(np.uint8)
        p = root / f"cxr_{i:03d}.jpg"
        Image.fromarray(img, "L").save(p, quality=90)
        paths.append(str(p))
    return paths


def stage1_model(tiny: bool, max_txt_len: int, device):
    """(cfg, stage-1 params without the trunk, trunk params, trunk state,
    policy, crop, resize)."""
    import torch
    from radialog_tpu_torch.models.biovil_t import biovil_t_init
    from radialog_tpu_torch.models.blip2 import Blip2Config, blip2_init
    from radialog_tpu_torch.ops.layers import BF16, FP32
    gen = torch.Generator(device=device).manual_seed(0)
    if tiny:
        from radialog_tpu_torch.models.qformer import TINY_QFORMER
        cfg = Blip2Config(qformer=TINY_QFORMER, max_txt_len=16)
        visual, vstate = biovil_t_init(gen, device, joint_feature_size=48,
                                       resnet_layers=(1, 1, 1, 1), bottleneck=False)
        params, _ = blip2_init(gen, cfg, device, with_vision=False)
        return cfg, params, visual, vstate, FP32, 64, 72
    cfg = Blip2Config(max_txt_len=max_txt_len)
    params, state = blip2_init(gen, cfg, device, with_vision=True)
    visual = params.pop("visual")
    return cfg, params, visual, state["visual"], BF16, 448, 512


def run(args, device, model=None) -> Dict:
    import torch
    from radialog_tpu_torch.apps.tokenization import WhitespaceTokenizer
    from radialog_tpu_torch.data.prefetch import DevicePrefetcher, stage1_raw_batches
    from radialog_tpu_torch.train.optim import make_adamw
    from radialog_tpu_torch.train.steps import TrainState, make_stage1_raw_train_step
    tmp = Path(tempfile.mkdtemp(prefix="bench_pipe_"))
    try:
        paths = write_corpus(tmp, args.imgs, 96 if args.tiny else 512)
        cfg, params, visual, vstate, policy, crop, resize = (
            model or stage1_model(args.tiny, args.max_txt_len, device))
        n_total = args.steps * args.batch + args.batch      # one spare batch
        recs = [{"img_path": paths[i % len(paths)], "text_output": CAPTIONS[i % len(CAPTIONS)]}
                for i in range(n_total)]
        tok = WhitespaceTokenizer(vocab_size=cfg.qformer.bert.vocab_size)
        tx = make_adamw(1e-4, weight_decay=1e-4)
        step_fn = make_stage1_raw_train_step(tx, cfg, policy=policy)
        st = TrainState.create(params, tx)

        def batches():
            return stage1_raw_batches(_Records(recs), tok, cfg.max_txt_len, args.batch,
                                      sub_epoch=0, resize=resize, crop=crop,
                                      threads=args.threads, drop_last=True)

        def on_card(hb):
            return {k: torch.as_tensor(v).to(device) for k, v in hb.items()}

        def step(state, batch):
            gen = torch.Generator(device=device).manual_seed(0)   # one key, as JAX's
            return step_fn(state, visual, vstate, batch, gen)

        it = iter(batches())            # warm-up on the first composed batch
        st, m = step(st, on_card(next(it)))
        it.close()                      # its loader's workers stop before the timed run
        done, per_step = 0, []
        t0 = last = clock(device)

        def consume(batch):
            nonlocal st, m, done, last
            if not args.no_step:
                st, m = step(st, batch)
            done += 1
            now = clock(device)
            per_step.append(now - last)
            last = now
            return done >= args.steps
        if args.no_prefetch:
            for hb in batches():
                if consume(on_card(hb)):
                    break
        else:
            with DevicePrefetcher(batches(), depth=args.depth, device=device) as pf:
                for batch in pf:
                    if consume(batch):
                        break
        wall = clock(device) - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ps = sorted(per_step)
    line = {"mode": "stage1-composed", "batch": args.batch, "steps": done,
            "threads": args.threads, "depth": args.depth, "wall_s": round(wall, 2),
            "images_per_sec": round(done * args.batch / wall, 1),
            "ms_per_step": round(1e3 * wall / done, 1),
            "no_step": bool(args.no_step), "no_prefetch": bool(args.no_prefetch),
            "step_ms_p50": round(1e3 * ps[len(ps) // 2], 1),
            "step_ms_p90": round(1e3 * ps[int(len(ps) * 0.9)], 1),
            "first5_ms": [round(1e3 * x, 1) for x in per_step[:5]],
            "note": NOTE, "device": device_label(device),
            "runs_s": [round(x, 4) for x in per_step]}
    print(json.dumps(line), flush=True)
    return line


def main(argv: Optional[List[str]] = None, model=None) -> Dict:
    """``model``: ``stage1_model``'s tuple to use in place of the tool's own."""
    args = build_parser().parse_args(argv)
    dev = open_device("cpu" if args.tiny else args.device)
    return run(args, dev, model)


if __name__ == "__main__":
    main()
