"""Findings-classifier training and prediction command line (port of the
root chexpert_train.py): ``--train`` trains the CheXpert classifier with
BCE and per-class positive weights (``--loss_weighting``), keeping the best
checkpoint by validation macro-F1; ``--save_preds`` writes
structured_preds_<run_name>.json.

  python -m radialog_tpu_torch.apps.chexpert_train --mock --epochs 1 \\
      --steps 3 --train --save_preds [--device cpu]

Without ``--device`` it runs on the card. The mock writes random JPEGs and
reads them through the loader (native/loader.py ``CxrLoader``, resize 512,
centre crop 488), as the real data would come in; a run that is not a mock
stops, as in the JAX package: it needs the MIMIC-CXR image tree.
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..core.checkpoint import BestKeeper
from ..core.mesh import init_distributed
from ..models.chexpert import NUM_CLASSES, chexpert_classifier_apply, chexpert_classifier_init
from ..native.loader import CxrLoader
from ..ops.layers import set_precision
from ..train.classifier import (class_weights, make_classifier_train_step, multilabel_f1,
                                save_structured_predictions)
from ..train.optim import make_adamw, tree_map
from ..train.steps import TrainState


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="CheXpert findings classifier (PyTorch)")
    p.add_argument("--run_name", type=str, default="chexpert_train")
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--loss_weighting", type=str, default="log",
                   choices=["none", "lin", "log"])
    p.add_argument("--train", action="store_true", default=False)
    p.add_argument("--save_preds", action="store_true", default=False)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="findings_classifier_out")
    p.add_argument("--mock", action="store_true", default=False)
    p.add_argument("--steps", type=int, default=None, help="mock: steps/epoch")
    p.add_argument("--image_size", type=int, default=488)  # load-bearing crop
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _mock_images(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """n random 600 x 520 gray JPEGs written to a temporary directory and
    read back through CxrLoader (resize 512, centre crop ``size``), in file
    order: (n, size, size, 3) f32 in [0, 1]."""
    from PIL import Image
    img_dir = Path(tempfile.mkdtemp(prefix="chexpert_imgs_"))
    try:
        paths = []
        for i in range(n):
            p = img_dir / f"dcm{i:03d}.jpg"
            Image.fromarray(rng.integers(0, 255, (600, 520), np.uint8), "L").save(p)
            paths.append(str(p))
        with CxrLoader(paths, batch=n, resize=512, crop=size, threads=2, shuffle=False) as ld:
            batches = list(ld.epoch())
    finally:
        shutil.rmtree(img_dir, ignore_errors=True)
    order = np.concatenate([ix for _, ix in batches])
    return np.concatenate([im for im, _ in batches])[np.argsort(order)]


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    init_distributed(device=args.device)   # a no-op without the RADIALOG_* environment
    if not args.mock:
        raise SystemExit("real training needs the MIMIC-CXR image tree; "
                         "use --mock for the synthetic smoke run")
    device = torch.device(args.device)
    if device.type == "cuda":
        set_precision()

    # the 488 crop is load-bearing: ResNet stride 32 -> 16x16 grid ->
    # avg_pool(4) -> 4x4 -> fc1 expects 128*4*4 inputs
    size = args.image_size
    rng = np.random.default_rng(0)
    n = 8
    labels = rng.integers(0, 2, (n, NUM_CLASSES)).astype(np.float32)
    images = _mock_images(rng, n, size)
    pw = class_weights(labels, args.loss_weighting)
    print("class weights (first 4):", np.round(pw[:4], 3))

    # drawn on the host from seed 0, so a CPU run and a card run start alike
    params, state = (tree_map(lambda t: t.to(device), tree) for tree in
                     chexpert_classifier_init(torch.Generator().manual_seed(0), "cpu"))
    tx = make_adamw(args.lr, weight_decay=0.0)
    tstate = TrainState.create(params, tx)
    step_fn = make_classifier_train_step(tx, pw)

    @torch.no_grad()
    def predict(p, s, im):
        return torch.sigmoid(chexpert_classifier_apply(p, s, torch.as_tensor(im, device=device)))

    keeper = BestKeeper(args.output_dir, mode="max")
    bs = 4
    steps = args.steps or (n // bs)
    if args.train or not args.save_preds:
        for epoch in range(args.epochs):
            for _ in range(steps):
                sel = rng.integers(0, n, bs)
                batch = {"images": images[sel], "labels": labels[sel]}
                tstate, state, metrics = step_fn(tstate, state, batch)
            probs = predict(tstate.params, state, images).cpu().numpy()
            m = multilabel_f1(labels, probs)
            keeper.update(int(tstate.step), m["val_f1"], tstate.params, {"val_f1": m["val_f1"]})
            print(json.dumps({"epoch": epoch, "loss": float(metrics["loss"]),
                              "val_f1": m["val_f1"], "val_acc": m["val_acc"]}))

    if args.save_preds:
        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
        out = f"{args.output_dir}/structured_preds_{args.run_name}.json"
        batches = [([f"dcm{i:03d}" for i in range(j, j + bs)], images[j:j + bs])
                   for j in range(0, n, bs)]
        preds = save_structured_predictions(lambda im: predict(tstate.params, state, im),
                                            batches, out)
        print(f"wrote {len(preds)} structured predictions -> {out}")


if __name__ == "__main__":
    main()
