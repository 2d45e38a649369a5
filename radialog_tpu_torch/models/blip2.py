"""BLIP-2 stage-1 model (port of radialog_tpu/models/blip2.py): the frozen
BioViL-T trunk, ``ln_vision``, the Q-Former and the ITC, ITM and LM heads,
plus the query embeddings the LLM reads (``blip2_forward_image``) and
greedy caption decoding.

  image -> biovil_t (frozen, J = 1408) -> projected patches, channel-major
  reshape to (B, 196, 1408) -> ln_vision -> Q-Former query pass (cache
  kept for the LM) -> ITC + ITM (hard negatives) + LM losses.

The hard negatives are drawn by ``sample_negatives``, one module-level
function of the weights and a generator, so that a test can hand in the
JAX package's own draws (``jax.random.categorical`` gives other numbers
than a ``torch.Generator``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.layers import (DTypePolicy, FP32, layernorm, layernorm_init, linear, linear_init,
                          upcast)
from .biovil_t import biovil_t_apply, biovil_t_init, patch_tokens_for_qformer
from .qformer import (QFormerConfig, lm_loss, qformer_image_grounded, qformer_init,
                      qformer_lm, qformer_multimodal, qformer_text)


@dataclasses.dataclass(frozen=True)
class Blip2Config:
    qformer: QFormerConfig = QFormerConfig()
    embed_dim: int = 256            # the ITC projection's width
    max_txt_len: int = 256
    image_size: int = 448


class Stage1Losses(NamedTuple):
    loss: torch.Tensor
    loss_itc: torch.Tensor
    loss_itm: torch.Tensor
    loss_lm: torch.Tensor


def blip2_init(gen, cfg: Blip2Config, device, with_vision: bool = True) -> Tuple[Dict, Dict]:
    """(params, state). ``with_vision=False`` leaves out the BioViL-T trunk
    (``params["visual"]`` and its batch-norm state ``state["visual"]``)."""
    h = cfg.qformer.bert.hidden_size
    params: Dict = {
        "qformer": qformer_init(gen, cfg.qformer, device),
        "ln_vision": layernorm_init(cfg.qformer.encoder_width, device),
        "vision_proj": linear_init(gen, h, cfg.embed_dim, device),
        "text_proj": linear_init(gen, h, cfg.embed_dim, device),
        "itm_head": linear_init(gen, h, 2, device),
        "temp": torch.tensor(0.07, dtype=torch.float32, device=device),
    }
    state: Dict = {}
    if with_vision:
        params["visual"], state["visual"] = biovil_t_init(
            gen, device, joint_feature_size=cfg.qformer.encoder_width)
    return params, state


def blip2_trunk_tokens(visual_params: Dict, visual_state: Dict, images: torch.Tensor,
                       policy: DTypePolicy = FP32) -> torch.Tensor:
    """images (B, 448, 448, 3) -> the trunk's raw patch tokens (B, 196,
    1408), before ln_vision: the frozen part (batch norm in eval mode).
    Stage-1 training runs it without gradients; ln_vision trains."""
    out = biovil_t_apply(visual_params, visual_state, images, policy=policy)
    return patch_tokens_for_qformer(out.projected_patch_embeddings)


def blip2_encode_image(params: Dict, state: Dict, images: torch.Tensor,
                       policy: DTypePolicy = FP32) -> torch.Tensor:
    """images (B, 448, 448, 3) -> ln_vision'd patch tokens (B, 196, 1408)."""
    tokens = blip2_trunk_tokens(params["visual"], state["visual"], images, policy=policy)
    return layernorm(params["ln_vision"], tokens)


def blip2_forward_image(params: Dict, cfg: Blip2Config, image_embeds: torch.Tensor,
                        policy: DTypePolicy = FP32) -> torch.Tensor:
    """ln_vision'd patch tokens (B, N, encoder_width) -> (B, 32, 768)."""
    return qformer_image_grounded(params["qformer"], cfg.qformer, image_embeds,
                                  policy=policy)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def _smoothed_ce(logits: torch.Tensor, targets: torch.Tensor, smoothing: float) -> torch.Tensor:
    logp = torch.log_softmax(upcast(logits), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[:, None])[:, 0]
    if smoothing > 0:
        nll = (1 - smoothing) * nll + smoothing * (-logp.mean(dim=-1))
    return nll.mean()


def sample_negatives(w_t2i: torch.Tensor, w_i2t: torch.Tensor,
                     gen: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hard negative per row, drawn with probability proportional to its
    weight: (negative image per text, negative text per image), each (B,)."""
    neg_img = torch.multinomial(w_t2i, 1, generator=gen)[:, 0]
    neg_txt = torch.multinomial(w_i2t, 1, generator=gen)[:, 0]
    return neg_img, neg_txt


def blip2_stage1_losses(params: Dict, cfg: Blip2Config, image_embeds: torch.Tensor,
                        text_ids: torch.Tensor, text_mask: torch.Tensor,
                        gen: Optional[torch.Generator], policy: DTypePolicy = FP32,
                        itm_chunks: int = 1) -> Stage1Losses:
    """ITC + ITM + LM over one in-batch sample set.

    image_embeds (B, N, 1408): ln_vision'd patch tokens. text_ids/text_mask
    (B, T): CLS-first BERT tokens. ``gen`` draws the hard negatives
    (``sample_negatives``). ``itm_chunks > 1`` runs the ITM pass over its 3B
    rows in that many equal chunks, each recomputed in the backward
    (``torch.utils.checkpoint``), so one chunk's activations are kept at a
    time; it must divide 3B.

    Kept as the JAX package has them: sim_t2i is sim_i2t transposed; temp
    trains and is not clamped; the negatives' weights are softmax + 1e-4
    with the diagonal set to 0; the LM input's first token is the BOS and
    its labels are -100 at padding; the ITM logits are the mean over the
    queries.
    """
    qcfg = cfg.qformer
    b = image_embeds.shape[0]
    nq = qcfg.num_query_tokens
    if itm_chunks > 1 and (3 * b) % itm_chunks:
        raise ValueError(f"itm_chunks {itm_chunks} must divide 3*batch ({3 * b})")

    query_hidden, query_cache = qformer_image_grounded(
        params["qformer"], qcfg, image_embeds, use_cache=True, policy=policy)
    image_feats = _normalize(upcast(linear(params["vision_proj"], query_hidden, policy)))
    text_hidden = qformer_text(params["qformer"], qcfg, text_ids, text_mask, policy=policy)
    text_feat = _normalize(upcast(linear(params["text_proj"], text_hidden[:, 0], policy)))

    # ITC, in batch
    sim_q2t = torch.einsum("iqe,te->itq", image_feats, text_feat)
    sim_i2t = sim_q2t.amax(dim=-1) / params["temp"]                   # (B, B)
    sim_t2i = sim_i2t.T
    targets = torch.arange(b, device=text_ids.device)
    loss_itc = 0.5 * (_smoothed_ce(sim_i2t, targets, 0.1) + _smoothed_ce(sim_t2i, targets, 0.1))

    # ITM with hard negatives
    with torch.no_grad():
        eye = torch.eye(b, dtype=torch.bool, device=text_ids.device)
        w_t2i = torch.where(eye, 0.0, torch.softmax(sim_t2i, dim=-1) + 1e-4)
        w_i2t = torch.where(eye, 0.0, torch.softmax(sim_i2t, dim=-1) + 1e-4)
        neg_img, neg_txt = sample_negatives(w_t2i, w_i2t, gen)
    ids_all = torch.cat([text_ids, text_ids, text_ids[neg_txt]], dim=0)
    mask_all = torch.cat([text_mask, text_mask, text_mask[neg_txt]], dim=0)
    image_all = torch.cat([image_embeds, image_embeds[neg_img], image_embeds], dim=0)
    attn_all = torch.cat([torch.ones((3 * b, nq), dtype=text_mask.dtype,
                                     device=text_mask.device), mask_all], dim=1)

    def itm_queries(ids, attn, img):
        return qformer_multimodal(params["qformer"], qcfg, ids, attn, img, policy=policy)[:, :nq]

    if itm_chunks > 1:
        itm_q = torch.cat([checkpoint(itm_queries, *chunk, use_reentrant=False)
                           for chunk in zip(ids_all.chunk(itm_chunks), attn_all.chunk(itm_chunks),
                                            image_all.chunk(itm_chunks))], dim=0)
    else:
        itm_q = itm_queries(ids_all, attn_all, image_all)
    itm_logits = linear(params["itm_head"], itm_q, policy).mean(dim=1)
    dev = text_ids.device
    itm_labels = torch.cat([torch.ones(b, dtype=torch.long, device=dev),
                            torch.zeros(2 * b, dtype=torch.long, device=dev)])
    loss_itm = _smoothed_ce(upcast(itm_logits), itm_labels, 0.0)

    # LM captioning over the cached queries
    dec_ids = text_ids.clone()
    dec_ids[:, 0] = qcfg.bos_token_id
    labels = torch.where(dec_ids == qcfg.pad_token_id, torch.full_like(dec_ids, -100), dec_ids)
    lm_mask = torch.cat([torch.ones((b, nq), dtype=text_mask.dtype, device=text_mask.device),
                         text_mask], dim=1)
    logits = qformer_lm(params["qformer"], qcfg, dec_ids, lm_mask, query_cache, policy=policy)
    loss_lm = lm_loss(logits, labels, label_smoothing=0.1)

    return Stage1Losses(loss=loss_itc + loss_itm + loss_lm, loss_itc=loss_itc,
                        loss_itm=loss_itm, loss_lm=loss_lm)


@torch.no_grad()
def blip2_generate_caption(params: Dict, cfg: Blip2Config, image_embeds: torch.Tensor,
                           max_length: int = 30, min_length: int = 10,
                           policy: DTypePolicy = FP32) -> torch.Tensor:
    """Greedy caption ids (B, max_length) int32 from the Q-Former LM: [DEC]
    first, SEP as the end, the SEP logit at -1e30 while fewer than
    ``min_length`` tokens stand, and a lane held at SEP once it is done.
    Each step runs the text stack over the whole row (positions after the
    step masked) on the query cache computed once."""
    qcfg = cfg.qformer
    b, dev = image_embeds.shape[0], image_embeds.device
    _, cache = qformer_image_grounded(params["qformer"], qcfg, image_embeds, use_cache=True,
                                      policy=policy)
    nq, eos = qcfg.num_query_tokens, qcfg.sep_token_id
    ids = torch.full((b, max_length), qcfg.pad_token_id, dtype=torch.int32, device=dev)
    ids[:, 0] = qcfg.bos_token_id
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    positions = torch.arange(max_length, device=dev)
    ones = torch.ones((b, nq), dtype=torch.int32, device=dev)
    for t in range(max_length - 1):
        mask = torch.cat([ones, (positions <= t).to(torch.int32)[None].expand(b, -1)], dim=1)
        step = qformer_lm(params["qformer"], qcfg, ids, mask, cache, policy=policy)[:, t]
        if t + 1 < min_length:
            step[:, eos] = -1e30
        nxt = torch.argmax(step, dim=-1).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
        ids[:, t + 1] = nxt
        done |= nxt == eos
    return ids
