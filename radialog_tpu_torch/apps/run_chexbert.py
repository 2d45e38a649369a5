"""CheXbert labeler command line (port of the root run_chexbert.py): label a
CSV of reports, or train the labeler.

``label`` reads one quoted report per line, labels them with the
pipeline's CheXbert (``RaDialogPipeline.label_reports``) and writes the
labels CSV the evaluation reads. ``train --mock`` trains a tiny BERT on
random tokens with dropout, keeping the best checkpoint by mean Cohen's
kappa over the 14 conditions.

  python -m radialog_tpu_torch.apps.run_chexbert label --reports_path R.csv \\
      --output_path labels.csv --mock [--device cpu]
  python -m radialog_tpu_torch.apps.run_chexbert train --mock [--device cpu]

Without ``--device`` it runs on the card.
"""
from __future__ import annotations

import argparse
import csv
from typing import List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="CheXbert labeler (PyTorch)")
    sub = p.add_subparsers(dest="cmd", required=True)
    lab = sub.add_parser("label")
    lab.add_argument("--reports_path", required=True,
                     help="CSV with one quoted report per line")
    lab.add_argument("--output_path", required=True)
    lab.add_argument("--checkpoint", default=None)
    lab.add_argument("--bert_tokenizer_path", default=None)
    lab.add_argument("--batch_size", type=int, default=16)
    lab.add_argument("--mock", action="store_true", default=False)
    lab.add_argument("--device", type=str, default="cuda")
    tr = sub.add_parser("train")
    tr.add_argument("--mock", action="store_true", default=False)
    tr.add_argument("--lr", type=float, default=2e-5)
    tr.add_argument("--steps", type=int, default=6)
    tr.add_argument("--output_dir", default="chexbert_out")
    tr.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def cmd_label(args) -> None:
    from ..eval.ce_metrics import write_labels_csv_from_raw
    from .pipeline import PipelineConfig, RaDialogPipeline

    with open(args.reports_path, newline="") as f:
        reports = [row[0] for row in csv.reader(f) if row]
    pipe = RaDialogPipeline(PipelineConfig(
        mock=args.mock, chexbert_checkpoint=args.checkpoint,
        bert_tokenizer_path=args.bert_tokenizer_path, device=args.device))
    labels = pipe.label_reports(reports, batch_size=args.batch_size)
    write_labels_csv_from_raw(labels, reports, args.output_path)
    print(f"labeled {len(reports)} reports -> {args.output_path}")


def cmd_train(args) -> None:
    from ..core.checkpoint import BestKeeper
    from ..models.bert import BertConfig
    from ..models.chexbert import chexbert_apply, chexbert_init
    from ..ops.layers import set_precision
    from ..train.chexbert_train import make_chexbert_train_step, mean_kappa
    from ..train.optim import make_adamw, tree_map
    from ..train.steps import TrainState

    if not args.mock:
        raise SystemExit("real training needs the CheXbert CSV data; use --mock")
    device = torch.device(args.device)
    if device.type == "cuda":
        set_precision()
    cfg = BertConfig(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
                     intermediate_size=64, max_position=64)
    rng = np.random.default_rng(0)
    n, t = 32, 24
    ids = rng.integers(4, 250, (n, t)).astype(np.int32)
    labels = np.concatenate([rng.integers(0, 4, (n, 13)),
                             rng.integers(0, 2, (n, 1))], axis=1).astype(np.int32)

    # weights drawn on the host from seed 0; dropout masks from seed 1 on the device
    params = tree_map(lambda x: x.to(device), chexbert_init(torch.Generator().manual_seed(0),
                                                            cfg, "cpu"))
    tx = make_adamw(args.lr, weight_decay=0.0)
    state = TrainState.create(params, tx)
    step_fn = make_chexbert_train_step(tx, cfg)
    keeper = BestKeeper(args.output_dir, mode="max")
    gen = torch.Generator(device=device).manual_seed(1)
    all_ids = torch.as_tensor(ids, device=device)
    all_mask = torch.ones((n, t), dtype=torch.int32, device=device)

    bs = 8
    for it in range(args.steps):
        sel = rng.integers(0, n, bs)
        batch = {"input_ids": ids[sel], "attention_mask": np.ones((bs, t), np.int32),
                 "labels": labels[sel]}
        state, metrics = step_fn(state, batch, gen)
        if it % 2 == 1:
            with torch.no_grad():
                logits = chexbert_apply(state.params, cfg, all_ids, all_mask)
            preds = np.stack([lg.argmax(-1).cpu().numpy() for lg in logits], axis=1)
            kappa, _ = mean_kappa(labels, preds)
            improved = keeper.update(it, kappa, state.params)
            print(f"step {it}: loss={float(metrics['loss']):.4f} "
                  f"kappa={kappa:.4f} best={improved}")


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.cmd == "label":
        cmd_label(args)
    else:
        cmd_train(args)


if __name__ == "__main__":
    main()
