"""Stage-1 (Q-Former) training runner and the embedding dump (port of
radialog_tpu/train/runner.py).

The epoch loop with the reference's custom epochs (``custom_epochs``
sub-epochs per epoch), the per-update learning-rate schedule, the best
checkpoint by mean validation loss, the JSON-lines log, the per-epoch
caption dumps, and the evaluate mode's query embeddings by dicom id in an
npz (the file ``apps/pipeline.py`` reads as ``emb_cache``).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..core.checkpoint import BestKeeper, load_checkpoint
from ..models.blip2 import Blip2Config
from ..train.optim import linear_warmup_cosine, make_adamw
from ..train.steps import TrainState, make_stage1_train_step
from ..utils.logging import JsonlLogger, MetricLogger


@dataclasses.dataclass
class Stage1Config:
    """The stage-1 YAML's run settings (configs/stage1_pretrain.yaml)."""

    max_epoch: int = 100
    custom_epochs: int = 2          # sub-epochs per epoch
    init_lr: float = 1e-4
    min_lr: float = 1e-5
    warmup_lr: float = 1e-6
    warmup_steps: int = 5000
    weight_decay: float = 0.05
    accum_grad_iters: int = 1
    output_dir: str = "outputs/stage1"
    log_freq: int = 50
    seed: int = 42
    resume: Optional[str] = None


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Stage1Runner:
    """Drives ``make_stage1_train_step`` over batch iterators, on the device
    of ``params``; the hard negatives come from one generator seeded with
    ``cfg.seed``."""

    def __init__(self, cfg: Stage1Config, blip2_cfg: Blip2Config, params: Dict,
                 steps_per_epoch: int):
        self.cfg = cfg
        self.device = params["temp"].device
        total = steps_per_epoch * cfg.max_epoch * cfg.custom_epochs
        self.tx = make_adamw(
            linear_warmup_cosine(cfg.init_lr, cfg.min_lr, cfg.warmup_steps, total,
                                 warmup_start_lr=cfg.warmup_lr),
            weight_decay=cfg.weight_decay, accum_steps=cfg.accum_grad_iters)
        if cfg.resume:      # the params BestKeeper wrote; the optimizer starts anew
            params, _ = load_checkpoint(Path(cfg.resume).parent, Path(cfg.resume).name,
                                        target=params)
        self.state = TrainState.create(params, self.tx)
        self.step_fn = make_stage1_train_step(self.tx, blip2_cfg)
        self.keeper = BestKeeper(cfg.output_dir, mode="min")
        self.logger = JsonlLogger(Path(cfg.output_dir) / "log.txt")
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def _step(self, batch: Dict, meter: MetricLogger) -> None:
        self.state, metrics = self.step_fn(self.state, batch, self.gen)
        meter.update(**{k: float(v) for k, v in metrics.items()})

    def train(self, train_batches: Callable[[int], Iterable[Dict]],
              val_batches: Optional[Callable[[], Iterable[Dict]]] = None,
              eval_fn: Optional[Callable] = None,
              generate_fn: Optional[Callable] = None,
              decode_fn: Optional[Callable] = None) -> TrainState:
        """train_batches(sub_epoch_index) yields batch dicts (image_embeds,
        text_ids, text_mask). With ``val_batches`` and ``eval_fn(params,
        batch, gen) -> loss`` each epoch validates and keeps the best
        params; ``generate_fn(params, batch) -> (B, T) ids`` and
        ``decode_fn(row) -> str`` add the caption dumps
        (``dump_val_generations``)."""
        cfg = self.cfg
        for epoch in range(cfg.max_epoch):
            for sub in range(cfg.custom_epochs):
                meter = MetricLogger()
                for batch in meter.log_every(train_batches(epoch * cfg.custom_epochs + sub),
                                             cfg.log_freq, header=f"epoch {epoch}.{sub}"):
                    self._step(batch, meter)
                self.logger.log({"split": "train", "epoch": epoch, "sub": sub,
                                 **meter.global_avgs()})
            if val_batches is not None and eval_fn is not None:
                val_loss = self.validate(val_batches, eval_fn)
                improved = self.keeper.update(int(self.state.step), val_loss, self.state.params)
                self.logger.log({"split": "val", "epoch": epoch, "loss": val_loss,
                                 "best": improved})
                if generate_fn is not None and decode_fn is not None:
                    self.dump_val_generations(epoch, val_batches, generate_fn, decode_fn)
        return self.state

    def dump_val_generations(self, epoch: int, val_batches: Callable[[], Iterable[Dict]],
                             generate_fn: Callable, decode_fn: Callable,
                             split_name: str = "val", html_rows: int = 5) -> Dict[str, list]:
        """Writes ``predictions/predictions_{split}.txt`` and
        ``ground_truths/ground_truths_{split}.txt`` under output_dir, one
        double-quoted caption a line, and sends an HTML table of the first
        ``html_rows`` (epoch, predicted, ground truth) rows to the logger's
        wandb run where it has one."""
        preds, gts = [], []
        for batch in val_batches():
            preds += [decode_fn(row) for row in _numpy(generate_fn(self.state.params, batch))]
            gts += [decode_fn(row) for row in _numpy(batch["text_ids"])]
        out = Path(self.cfg.output_dir)
        for sub, name, lines in (("predictions", "predictions", preds),
                                 ("ground_truths", "ground_truths", gts)):
            (out / sub).mkdir(parents=True, exist_ok=True)
            with open(out / sub / f"{name}_{split_name}.txt", "w") as f:
                f.writelines('"' + x + '"\n' for x in lines)
        rows = [[str(epoch), p, g] for p, g in list(zip(preds, gts))[:html_rows]]
        html = generate_html_table(rows, ["Epoch", "Predicted", "GT"])
        if getattr(self.logger, "wandb_run", None) is not None:
            import wandb
            self.logger.wandb_run.log({f"text_predictions_{split_name}": wandb.Html(html)})
        return {"predictions": preds, "ground_truths": gts}

    def train_iters(self, batches: Iterable[Dict], iters_per_inner_epoch: int, max_iters: int,
                    val_batches: Optional[Callable[[], Iterable[Dict]]] = None,
                    eval_fn: Optional[Callable] = None) -> TrainState:
        """Inner epochs of ``iters_per_inner_epoch`` iterations over one
        continuous stream of batches, each validated and checkpointed."""
        cfg = self.cfg
        meter = MetricLogger()
        it = iter(batches)
        done = 0
        while done < max_iters:
            n = min(iters_per_inner_epoch, max_iters - done)
            for _ in meter.log_every(range(n), cfg.log_freq, header=f"iters {done}"):
                self._step(next(it), meter)
            done += n
            self.logger.log({"split": "train", "iters": done, **meter.global_avgs()})
            if val_batches is not None and eval_fn is not None:
                val_loss = self.validate(val_batches, eval_fn)
                improved = self.keeper.update(done, val_loss, self.state.params)
                self.logger.log({"split": "val", "iters": done, "loss": val_loss,
                                 "best": improved})
        return self.state

    def validate(self, val_batches: Callable[[], Iterable[Dict]], eval_fn: Callable) -> float:
        """The mean of ``eval_fn`` over the batches, each batch's negatives
        drawn from a generator seeded 0, so a validation repeats exactly."""
        losses = [float(eval_fn(self.state.params, batch,
                                torch.Generator(device=self.device).manual_seed(0)))
                  for batch in val_batches()]
        return float(np.mean(losses)) if losses else float("nan")


def generate_html_table(data, columns) -> str:
    """The reference's wandb sample table (runner_base.py:73-87)."""
    head = "".join(f"<th>{col}</th>" for col in columns)
    body = "".join("<tr>" + "".join(f"<td>{cell}</td>" for cell in row) + "</tr>"
                   for row in data)
    return (f'<table border="1" cellpadding="5" cellspacing="0"><tr>{head}</tr>'
            f"{body}</table>")


def precompute_embeddings(forward_image: Callable, batches: Iterable,
                          out_path: str | Path) -> int:
    """Query embeddings keyed by dicom id into an npz (f32). ``batches``
    yields (dicom_ids, images or embeddings); ``forward_image`` maps the
    second to (B, 32, 768). Returns the number of ids written."""
    store: Dict[str, np.ndarray] = {}
    for dicom_ids, images in batches:
        for d, e in zip(dicom_ids, _numpy(forward_image(images))):
            store[str(d)] = e.astype(np.float32)
    np.savez(out_path, **store)
    return len(store)
