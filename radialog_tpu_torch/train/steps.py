"""The LoRA finetune step (port of radialog_tpu/train/steps.py
``lora_loss_fn`` and ``make_lora_train_step``). The Q-Former stage-1 steps
are not ported yet.

Only the LoRA tree (adapters, ``img_proj`` and the scale) records
gradients; the base stays frozen. A step returns a new ``TrainState`` and
changes nothing in place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..models.llama import LlamaConfig, find_img_start, llama_apply, prefill_bias
from ..ops.layers import DTypePolicy, FP32
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
        params = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
        loss = lora_loss_fn(params, base_params, cfg, batch, policy, remat, flash)
        leaves = tree_leaves(params)
        found = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(found)
        grads = tree_map(lambda p: _or_zeros(next(it), p), params)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state, state.params)
            new_params = apply_updates(state.params, updates)
            gnorm = global_norm(grads)
        return (TrainState(new_params, opt_state, state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return step


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g
