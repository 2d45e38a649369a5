"""Train steps (port of radialog_tpu/train/steps.py): the LoRA finetune
step and the Q-Former stage-1 steps, over precomputed image embeddings and
over raw images.

Only the trainable tree records gradients: the LoRA tree (adapters,
``img_proj`` and the scale), or the stage-1 tree without the frozen
BioViL-T trunk. A step returns a new ``TrainState`` and changes nothing in
place.

Across ranks (one process each, core/mesh.py): a LoRA step built with a
``mesh`` runs this rank's shard of the base and the adapters
(parallel/partition.py) over its slice of the global batch, and a stage-1
step built with a ``data_group`` its slice of the batch. Each rank's loss
is its share of the global one: the sum over its rows divided by the global
count (labels, pairs or tokens), so the shares add up to the one-process
loss whatever rows each rank holds. The gradients are summed over
``data``, and over ``model`` for the replicated LoRA leaves that each
model rank sees in part (``lora_grad_axes``); the metrics are the global
values on every rank. The JAX package gets the same from one controller
(XLA inserts the collectives).
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
from ..parallel.collectives import sum_over
from .optim import GradientTransformation, apply_updates, global_norm, tree_leaves, tree_map

IGNORE_INDEX = -100   # labels of prompt and padding tokens


class TrainState(NamedTuple):
    params: Any          # the trainable tree
    opt_state: Any
    step: int

    @classmethod
    def create(cls, params: Any, tx: GradientTransformation) -> "TrainState":
        return cls(params, tx.init(params), 0)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor, data_group=None) -> torch.Tensor:
    """Next-token cross entropy over the labels that are not IGNORE_INDEX
    (shift by one), summed and divided by their count (at least 1).
    ``data_group``: the rows are this rank's slice of a batch split over the
    group, and the count is the whole batch's (summed over the group first),
    as the JAX package divides by the count of the whole sharded batch; the
    result is this rank's share of the global loss."""
    v = logits.shape[-1]
    targets = labels[:, 1:].reshape(-1).long()
    nll = F.cross_entropy(logits[:, :-1].reshape(-1, v).float(), targets,
                          ignore_index=IGNORE_INDEX, reduction="sum")
    count = sum_over([(targets != IGNORE_INDEX).sum()], data_group)[0]
    return nll / torch.clamp(count, min=1)


def lora_loss_fn(lora: Dict, base_params: Dict, cfg: LlamaConfig, batch: Dict[str, torch.Tensor],
                 policy: DTypePolicy = FP32, remat: bool = False,
                 flash: bool = False, tp_group=None, data_group=None) -> torch.Tensor:
    """Full-sequence forward with the <IMG> splice, then the masked loss.

    batch: tokens (B,T) right-padded, labels (B,T) with -100 on prompt and
    padding, lengths (B,), img_embs (B,32,768) optional. ``flash`` routes
    attention of 256 tokens or more through the flash-attention kernels and
    their backward (ops/flash_attention.py); without it attention is ``mha``
    under autograd. Which of the two trains faster on a card is measured,
    not assumed (PERF.md).

    ``tp_group`` / ``data_group``: the model and data groups of a mesh;
    ``lora``, ``base_params`` and ``cfg`` are then this rank's shard and
    ``shard_config``'s view, the batch this rank's rows, and the result its
    share of the global loss (``masked_ce``)."""
    tokens, labels, lengths = batch["tokens"], batch["labels"], batch["lengths"]
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device)[None, :].repeat(b, 1)
    img_embs = batch.get("img_embs")
    img_start = find_img_start(tokens, cfg.img_token_id) if img_embs is not None else None
    logits, _ = llama_apply(base_params, cfg, tokens, positions, prefill_bias(lengths, t),
                            img_embs=img_embs, img_start=img_start, lora=lora, policy=policy,
                            remat=remat, lengths=lengths, flash=flash, tp_group=tp_group)
    return masked_ce(logits, labels, data_group)


def make_lora_train_step(tx: GradientTransformation, cfg: LlamaConfig,
                         policy: DTypePolicy = FP32, remat: bool = True,
                         flash: bool = False, mesh=None) -> Callable:
    """Returns step(state, base_params, batch) -> (state, metrics): metrics
    ``loss`` and ``grad_norm`` (of this micro-batch's gradients, before the
    clip), 0-d tensors.

    ``mesh`` (core/mesh.make_mesh): ``state.params`` and ``base_params``
    are this rank's ``shard_params`` trees, the batch its rows of the global
    micro-batch (``shard_batch``), and ``cfg`` the unsharded config; the
    metrics are the global ones on every rank (module docstring). ``tx``
    clips by the whole tree's norm when it is built with the LoRA specs and
    the mesh (optim.make_adamw)."""
    cfg_local, tp_group, data_group = cfg, None, None
    if mesh is not None:
        from ..core.mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_size
        from ..parallel.tp_serving import shard_config
        cfg_local = shard_config(cfg, axis_size(mesh, MODEL_AXIS))
        tp_group, data_group = axis_group(mesh, MODEL_AXIS), axis_group(mesh, DATA_AXIS)

    def step(state: TrainState, base_params: Dict, batch: Dict) -> Tuple[TrainState, Dict]:
        params = _trainable(state.params)
        loss = lora_loss_fn(params, base_params, cfg_local, batch, policy, remat, flash,
                            tp_group=tp_group, data_group=data_group)
        grads = _grads(loss, params)
        with torch.no_grad():
            specs = None
            if mesh is not None:
                from ..parallel.partition import lora_partition_specs
                grads, specs = reduce_lora_grads(mesh, grads), lora_partition_specs(params)
            new_state = _apply(tx, state, grads)
            gnorm = global_norm(grads, specs, mesh)
            loss = sum_over([loss.detach()], data_group)[0]
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step


def reduce_lora_grads(mesh, grads: Dict) -> Dict:
    """This rank's LoRA gradients summed over the axes of
    parallel/partition.py ``lora_grad_axes``: every leaf over ``data`` in
    one all-reduce, then ``a`` and ``scale`` over ``model`` in another."""
    from ..core.mesh import DATA_AXIS, MODEL_AXIS, axis_group
    from ..parallel.partition import lora_grad_axes, map_specs
    leaves = tree_leaves(grads)
    on_model = tree_leaves(map_specs(lambda g, axes: MODEL_AXIS in axes, grads,
                                     lora_grad_axes(grads)))
    leaves = sum_over(leaves, axis_group(mesh, DATA_AXIS))
    idx = [i for i, m in enumerate(on_model) if m]
    for i, x in zip(idx, sum_over([leaves[i] for i in idx], axis_group(mesh, MODEL_AXIS))):
        leaves[i] = x
    found = iter(leaves)
    return tree_map(lambda _: next(found), grads)


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


def _stage1_update(tx: GradientTransformation, state: TrainState, params, out,
                   data_group=None) -> Tuple[TrainState, Dict]:
    """The stage-1 losses' gradients, summed over ``data_group``, applied:
    (new state, the four global losses)."""
    grads = _grads(out.loss, params)
    with torch.no_grad():
        leaves = iter(sum_over(tree_leaves(grads), data_group))
        new_state = _apply(tx, state, tree_map(lambda _: next(leaves), grads))
        names = list(out._fields)
        losses = sum_over([getattr(out, k).detach() for k in names], data_group)
    return new_state, dict(zip(names, losses))


def make_stage1_train_step(tx: GradientTransformation, cfg: Blip2Config,
                           policy: DTypePolicy = FP32, itm_chunks: int = 1,
                           data_group=None) -> Callable:
    """Q-Former stage 1 (ITC + ITM + LM) over precomputed image embeddings:
    step(state, batch, gen) -> (state, metrics). batch: image_embeds (B, N,
    1408), text_ids, text_mask (B, T). ``gen`` draws the hard negatives.
    Every leaf of ``state.params`` trains. ``data_group``: the batch is this
    rank's rows of a global batch split over the group, the losses and
    negatives global (``blip2_stage1_losses``); ``gen`` must be seeded alike
    on every rank."""

    def step(state: TrainState, batch: Dict, gen) -> Tuple[TrainState, Dict]:
        params = _trainable(state.params)
        batch = _on(batch, params["temp"].device)
        out = blip2_stage1_losses(params, cfg, batch["image_embeds"], batch["text_ids"],
                                  batch["text_mask"], gen, policy=policy, itm_chunks=itm_chunks,
                                  data_group=data_group)
        return _stage1_update(tx, state, params, out, data_group)

    return step


def make_stage1_raw_train_step(tx: GradientTransformation, cfg: Blip2Config,
                               policy: DTypePolicy = FP32, augment: bool = False,
                               itm_chunks: int = 1, data_group=None) -> Callable:
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
    never applies it, so it is off by default. ``data_group`` as in
    ``make_stage1_train_step``.
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
                                  batch["text_mask"], gen, policy=policy, itm_chunks=itm_chunks,
                                  data_group=data_group)
        return _stage1_update(tx, state, params, out, data_group)

    return step


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g
