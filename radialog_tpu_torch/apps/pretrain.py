"""Q-Former stage-1 pretraining command line (port of the root
pretrain.py): ``--cfg-path`` YAML with ``--options`` overrides; ``--mock``
trains a tiny Q-Former on random embeddings, ``--mock --raw`` from JPEG
files written at run time (the loader, the prefetcher, the frozen trunk
inside the step), and ``--evaluate`` writes the query embeddings to an npz.
Weights are drawn on the host from seed 0, so a CPU run and a card run
start from the same numbers.

  python -m radialog_tpu_torch.apps.pretrain --mock --max-epoch 1 \\
      --steps-per-epoch 2 [--raw] [--evaluate] [--device cpu]

Without ``--device`` it runs on the card. A run that is not a mock stops,
as in the JAX package: it needs MIMIC-CXR and a BERT tokenizer.
"""
from __future__ import annotations

import argparse
import csv
import itertools
import shutil
import tempfile
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.mesh import init_distributed
from ..data.datasets import MimicPaths, Stage1Data
from ..data.prefetch import DevicePrefetcher, stage1_raw_batches
from ..models.biovil_t import biovil_t_init
from ..models.blip2 import (Blip2Config, blip2_forward_image, blip2_generate_caption,
                            blip2_init, blip2_stage1_losses)
from ..models.qformer import TINY_QFORMER
from ..native.loader import native_available
from ..ops.layers import set_precision
from ..train.optim import make_adamw, tree_map
from ..train.runner import Stage1Config, Stage1Runner, precompute_embeddings
from ..train.steps import TrainState, make_stage1_raw_train_step
from .tokenization import WhitespaceTokenizer


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="RaDialog stage-1 pretraining (PyTorch)")
    p.add_argument("--cfg-path", default=None)
    p.add_argument("--options", nargs="+", default=None)
    p.add_argument("--mock", action="store_true", default=False)
    p.add_argument("--raw", action="store_true", default=False,
                   help="train from JPEG files (the frozen trunk inside the step) instead "
                        "of precomputed embeddings")
    p.add_argument("--use_augs", action="store_true", default=False,
                   help="apply the train-time augmentation (RandomAffine + ColorJitter); "
                        "off by default, as the reference builds it for stage 1 but never "
                        "applies it")
    p.add_argument("--evaluate", action="store_true", default=False,
                   help="precompute the Q-Former embeddings instead of training")
    p.add_argument("--max-epoch", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="mock mode: synthetic batches per sub-epoch")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--output-dir", type=str, default="outputs/stage1")
    p.add_argument("--emb-out", type=str, default="embs.npz")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    init_distributed(device=args.device)   # a no-op without the RADIALOG_* environment
    device = torch.device(args.device)
    if device.type == "cuda":
        set_precision()
    cfg = Config.from_yaml(args.cfg_path) if args.cfg_path else Config()
    if args.options:
        cfg = cfg.apply_overrides(args.options)
    run = cfg.get("run", Config())
    scfg = Stage1Config(
        max_epoch=args.max_epoch or run.get("max_epoch", 100),
        init_lr=run.get("init_lr", 1e-4), min_lr=run.get("min_lr", 1e-5),
        warmup_steps=run.get("warmup_steps", 5000),
        weight_decay=run.get("weight_decay", 0.05),
        accum_grad_iters=run.get("accum_grad_iters", 1), output_dir=args.output_dir)
    if args.mock and args.raw:
        run_mock_raw(args, scfg, device)
    elif args.mock:
        run_mock(args, scfg, device)
    else:
        raise SystemExit(
            "non-mock stage-1 training needs MIMIC-CXR data + a BERT tokenizer: "
            "point --cfg-path at a YAML with dataset paths (see configs/)")


def _mock_params(bcfg: Blip2Config, device, with_vision: bool = False):
    params, state = blip2_init(torch.Generator().manual_seed(0), bcfg, "cpu",
                               with_vision=with_vision)
    return (tree_map(lambda t: t.to(device), params),
            tree_map(lambda t: t.to(device), state))


def run_mock(args, scfg: Stage1Config, device) -> None:
    """The tiny Q-Former on random embeddings: training with validation and
    the caption dumps, or (``--evaluate``) the embeddings' npz."""
    bcfg = Blip2Config(qformer=TINY_QFORMER, max_txt_len=16)
    params, _ = _mock_params(bcfg, device)
    b, spe = 4, args.steps_per_epoch or 2
    width = bcfg.qformer.encoder_width
    rng = np.random.default_rng(0)

    def batches(_sub):
        for _ in range(spe):
            yield {"image_embeds": rng.normal(size=(b, 16, width)).astype(np.float32),
                   "text_ids": rng.integers(4, bcfg.qformer.bert.vocab_size - 4,
                                            (b, 12)).astype(np.int32),
                   "text_mask": np.ones((b, 12), np.int32)}

    def on_device(x):
        return torch.as_tensor(x, device=device)

    if args.evaluate:
        def forward(embs):
            with torch.no_grad():
                return blip2_forward_image(params, bcfg, on_device(embs))
        n = precompute_embeddings(
            forward, (((f"d{i}", f"d{i + 1}"),
                       rng.normal(size=(2, 16, width)).astype(np.float32)) for i in range(0, 6, 2)),
            args.emb_out)
        print(f"precomputed {n} embeddings -> {args.emb_out}")
        return

    runner = Stage1Runner(scfg, bcfg, params, steps_per_epoch=spe)

    def eval_fn(p, batch, gen):
        with torch.no_grad():
            return blip2_stage1_losses(p, bcfg, on_device(batch["image_embeds"]),
                                       on_device(batch["text_ids"]),
                                       on_device(batch["text_mask"]), gen).loss

    def gen_fn(p, batch):
        return blip2_generate_caption(p, bcfg, on_device(batch["image_embeds"]),
                                      max_length=8, min_length=1)

    def decode(row):
        return " ".join(f"t{int(i)}" for i in row if int(i) > 3)

    runner.train(batches, val_batches=lambda: batches(0), eval_fn=eval_fn,
                 generate_fn=gen_fn, decode_fn=decode)
    print("stage-1 mock training done; outputs in", scfg.output_dir)


def _mock_tree(rng: np.random.Generator, n: int) -> Path:
    """A miniature MIMIC tree under a new temporary directory: n random
    96 x 80 gray JPEGs (PIL writes them) and the split and sectioned CSVs."""
    from PIL import Image
    tmp = Path(tempfile.mkdtemp(prefix="stage1_raw_"))
    img_root = tmp / "images"
    captions = ["lungs are clear no effusion", "mild cardiomegaly is seen",
                "right pleural effusion present", "no acute process"]
    rows = []
    for i in range(n):
        folder = f"files/p10/p100000{i:02d}/s5000000{i}"
        (img_root / folder).mkdir(parents=True)
        dicom = f"dcm-{i:03d}"
        Image.fromarray(rng.integers(0, 255, (96, 80), np.uint8), "L").save(
            img_root / folder / f"{dicom}.jpg")
        rows.append((dicom, captions[i % len(captions)], folder, f"{dicom}.jpg",
                     f"s5000000{i}.txt"))
    with open(tmp / "split.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["dicom_id", "split"])
        w.writerows((dicom, "train") for dicom, *_ in rows)
    with open(tmp / "sectioned.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["findings", "dicom_id", "Img_Folder", "Img_Filename", "Note_file"])
        w.writerows((cap, dicom, folder, fn, note) for dicom, cap, folder, fn, note in rows)
    return tmp


def run_mock_raw(args, scfg: Stage1Config, device) -> None:
    """Stage 1 from image files end to end: JPEGs -> the dataset join ->
    CxrLoader -> DevicePrefetcher -> the frozen trunk inside the step ->
    ITC + ITM + LM. No precomputed embeddings anywhere."""
    bcfg = Blip2Config(qformer=TINY_QFORMER, max_txt_len=16)
    rng = np.random.default_rng(0)
    n, b = 8, 4
    tmp = _mock_tree(rng, n)
    try:
        _train_raw(args, scfg, device, bcfg, tmp, b)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _train_raw(args, scfg: Stage1Config, device, bcfg: Blip2Config, tmp: Path, b: int) -> None:
    data = Stage1Data(MimicPaths(split_csv=str(tmp / "split.csv"),
                                 sectioned_csv=str(tmp / "sectioned.csv"), chexpert_csv="",
                                 image_root=str(tmp / "images")),
                      split="train", custom_epochs_per_epoch=2)
    tok = WhitespaceTokenizer(vocab_size=TINY_QFORMER.bert.vocab_size)
    # a tiny trunk: BioViL-T at 64 px -> a 2 x 2 grid -> 4 tokens
    host = torch.Generator().manual_seed(1)
    visual_params, visual_state = (tree_map(lambda t: t.to(device), tree) for tree in
                                   biovil_t_init(host, "cpu",
                                                 joint_feature_size=TINY_QFORMER.encoder_width))
    params, _ = _mock_params(bcfg, device)
    tx = make_adamw(scfg.init_lr, weight_decay=scfg.weight_decay)
    state = TrainState.create(params, tx)
    step_fn = make_stage1_raw_train_step(tx, bcfg, augment=args.use_augs)
    gen = torch.Generator(device=device).manual_seed(scfg.seed)
    spe = args.steps_per_epoch or 2
    for epoch in range(args.max_epoch or 1):
        for sub in range(data.custom_epochs_per_epoch):
            batches = itertools.islice(itertools.cycle(stage1_raw_batches(
                data, tok, bcfg.max_txt_len, batch=b, sub_epoch=sub, resize=72, crop=64,
                threads=2, seed=epoch, drop_last=False)), spe)
            with DevicePrefetcher(batches, depth=2, device=device) as pf:
                for it, batch in enumerate(pf):
                    state, m = step_fn(state, visual_params, visual_state, batch, gen)
                    print(f"epoch {epoch}.{sub} it {it}: loss={float(m['loss']):.4f} "
                          f"itc={float(m['loss_itc']):.4f} itm={float(m['loss_itm']):.4f} "
                          f"lm={float(m['loss_lm']):.4f}")
    route = "native" if native_available() else "pil"
    print(f"raw-image stage-1 mock done (JPEG -> {route} loader -> loss, no precomputed "
          "embeds)")


if __name__ == "__main__":
    main()
