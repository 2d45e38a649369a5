"""Train steps (port of radialog_tpu/train/steps.py): the LoRA finetune
step and the Q-Former stage-1 steps, over precomputed image embeddings and
over raw images.

Only the trainable tree records gradients: the LoRA tree (adapters,
``img_proj`` and the scale), or the stage-1 tree without the frozen
BioViL-T trunk. A step returns a new ``TrainState`` and changes nothing in
place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.blip2 import Blip2Config, blip2_stage1_losses, blip2_trunk_tokens
from ..models.llama import LlamaConfig, find_img_start, llama_apply, prefill_bias
from ..ops.augment import augment_cxr_batch
from ..ops.image import expand_cxr_u8
from ..ops.layers import DTypePolicy, FP32, layernorm
from .optim import GradientTransformation, apply_updates, global_norm, tree_leaves, tree_map

IGNORE_INDEX = -100   # labels of prompt and padding tokens


class TrainState(NamedTuple):
    params: Any          # the trainable tree
    opt_state: Any
    step: int

    @classmethod
    def create(cls, params: Any, tx: GradientTransformation) -> "TrainState":
        return cls(params, tx.init(params), 0)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy over the labels that are not IGNORE_INDEX
    (shift by one), averaged over their count (at least 1)."""
    v = logits.shape[-1]
    targets = labels[:, 1:].reshape(-1).long()
    nll = F.cross_entropy(logits[:, :-1].reshape(-1, v).float(), targets,
                          ignore_index=IGNORE_INDEX, reduction="sum")
    return nll / torch.clamp((targets != IGNORE_INDEX).sum(), min=1)


def lora_loss_fn(lora: Dict, base_params: Dict, cfg: LlamaConfig, batch: Dict[str, torch.Tensor],
                 policy: DTypePolicy = FP32, remat: bool = False,
                 flash: bool = False) -> torch.Tensor:
    """Full-sequence forward with the <IMG> splice, then the masked loss.

    batch: tokens (B,T) right-padded, labels (B,T) with -100 on prompt and
    padding, lengths (B,), img_embs (B,32,768) optional. ``flash`` routes
    attention of 256 tokens or more through the flash-attention kernels and
    their backward (ops/flash_attention.py); without it attention is ``mha``
    under autograd. Which of the two trains faster on a card is measured,
    not assumed (PERF.md)."""
    tokens, labels, lengths = batch["tokens"], batch["labels"], batch["lengths"]
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device)[None, :].repeat(b, 1)
    img_embs = batch.get("img_embs")
    img_start = find_img_start(tokens, cfg.img_token_id) if img_embs is not None else None
    logits, _ = llama_apply(base_params, cfg, tokens, positions, prefill_bias(lengths, t),
                            img_embs=img_embs, img_start=img_start, lora=lora, policy=policy,
                            remat=remat, lengths=lengths, flash=flash)
    return masked_ce(logits, labels)


def make_lora_train_step(tx: GradientTransformation, cfg: LlamaConfig,
                         policy: DTypePolicy = FP32, remat: bool = True,
                         flash: bool = False) -> Callable:
    """Returns step(state, base_params, batch) -> (state, metrics): metrics
    ``loss`` and ``grad_norm`` (of this micro-batch's gradients, before the
    clip), 0-d tensors."""

    def step(state: TrainState, base_params: Dict, batch: Dict) -> Tuple[TrainState, Dict]:
        params = _trainable(state.params)
        loss = lora_loss_fn(params, base_params, cfg, batch, policy, remat, flash)
        grads = _grads(loss, params)
        with torch.no_grad():
            new_state = _apply(tx, state, grads)
            gnorm = global_norm(grads)
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def _trainable(tree):
    return tree_map(lambda p: p.detach().requires_grad_(True), tree)


def _grads(loss: torch.Tensor, params):
    """d loss / d params as a tree like params (zeros where a leaf is unused)."""
    found = iter(torch.autograd.grad(loss, tree_leaves(params), allow_unused=True))
    return tree_map(lambda p: _or_zeros(next(found), p), params)


def _apply(tx: GradientTransformation, state: TrainState, grads) -> TrainState:
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    return TrainState(apply_updates(state.params, updates), opt_state, state.step + 1)


def _on(batch: Dict, device) -> Dict:
    """The batch's arrays as tensors on ``device`` (numpy arrays copied)."""
    return {k: torch.as_tensor(v, device=device) if isinstance(v, (np.ndarray, torch.Tensor))
            else v for k, v in batch.items()}


def _stage1_update(tx: GradientTransformation, state: TrainState, params,
                   out) -> Tuple[TrainState, Dict]:
    """The stage-1 losses' gradients applied: (new state, the four losses)."""
    grads = _grads(out.loss, params)
    with torch.no_grad():
        new_state = _apply(tx, state, grads)
    return new_state, {k: v.detach() for k, v in out._asdict().items()}


def make_stage1_train_step(tx: GradientTransformation, cfg: Blip2Config,
                           policy: DTypePolicy = FP32, itm_chunks: int = 1) -> Callable:
    """Q-Former stage 1 (ITC + ITM + LM) over precomputed image embeddings:
    step(state, batch, gen) -> (state, metrics). batch: image_embeds (B, N,
    1408), text_ids, text_mask (B, T). ``gen`` draws the hard negatives.
    Every leaf of ``state.params`` trains."""

    def step(state: TrainState, batch: Dict, gen) -> Tuple[TrainState, Dict]:
        params = _trainable(state.params)
        batch = _on(batch, params["temp"].device)
        out = blip2_stage1_losses(params, cfg, batch["image_embeds"], batch["text_ids"],
                                  batch["text_mask"], gen, policy=policy, itm_chunks=itm_chunks)
        return _stage1_update(tx, state, params, out)

    return step


def make_stage1_raw_train_step(tx: GradientTransformation, cfg: Blip2Config,
                               policy: DTypePolicy = FP32, augment: bool = False,
                               itm_chunks: int = 1) -> Callable:
    """Stage 1 over raw images: step(state, visual_params, visual_state,
    batch, gen) -> (state, metrics).

    The frozen BioViL-T trunk (batch norm in eval) runs without gradients
    inside the step; ``ln_vision`` trains. ``state.params`` is the stage-1
    tree without "visual", so the trunk never enters the optimizer. batch:
    images (B, 448, 448, 3) f32 in [0, 1], or (B, 448, 448) uint8 crops
    (expanded on the device by ``expand_cxr_u8``, bitwise the f32 form),
    text_ids, text_mask (B, T). ``augment`` applies the train-time
    augmentation (ops/augment.py) on the device first, its draws from
    ``gen`` before the negatives'; the reference builds it for stage 1 but
    never applies it, so it is off by default.
    """

    def step(state: TrainState, visual_params: Dict, visual_state: Dict, batch: Dict,
             gen) -> Tuple[TrainState, Dict]:
        batch = _on(batch, state.params["temp"].device)
        with torch.no_grad():
            images = batch["images"]
            if images.dtype == torch.uint8:
                images = expand_cxr_u8(images)
            if augment:
                images = augment_cxr_batch(images, gen)
            tokens = blip2_trunk_tokens(visual_params, visual_state, images, policy)
        params = _trainable(state.params)
        image_embeds = layernorm(params["ln_vision"], tokens)
        out = blip2_stage1_losses(params, cfg, image_embeds, batch["text_ids"],
                                  batch["text_mask"], gen, policy=policy, itm_chunks=itm_chunks)
        return _stage1_update(tx, state, params, out)

    return step


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g
