"""The serving subset of the RaDialog pipeline (port of
radialog_tpu/apps/pipeline.py ``RaDialogPipeline``).

Covered: mock construction (tiny seeded models, real interface contract:
32 <IMG> slots, 32 queries) and synthetic full-width construction (Vicuna-7B,
BioViL-T, BERT-base Q-Former and the CheXpert classifier with random
weights from a seeded ``torch.Generator``), both with W8A8 weights and the
int8 KV cache; ``embed_images``, ``classify_findings``, the shared-prefix
rule and greedy ``generate_texts``. Loading real checkpoints, the CheXbert
labeler, beams and the continuous-batching ring are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..decode.engine import (DecodeParams, GenerationResult, generate,
                             generate_shared_prefix)
from ..models.biovil_t import biovil_t_apply, biovil_t_init, patch_tokens_for_qformer
from ..models.blip2 import Blip2Config, blip2_forward_image
from ..models.chexpert import (CHEXPERT_CLASSES, chexpert_classifier_apply,
                               chexpert_classifier_init, predicted_findings)
from ..models.llama import TINY_LLAMA, VICUNA_7B, llama_init, lora_init
from ..models.qformer import QFormerConfig, TINY_QFORMER, qformer_init
from ..ops.layers import BF16, DTypePolicy, FP32, layernorm, layernorm_init, set_precision
from ..ops.quant import quantize_llama_host, random_serving_params
from .tokenization import WhitespaceTokenizer, pad_batch_right

# shortest common prefix worth a separate prefix prefill (as in the JAX package)
SHARED_PREFIX_MIN = 16


@dataclasses.dataclass
class PipelineConfig:
    mock: bool = False              # tiny seeded models
    synthetic: bool = False         # full widths, random weights
    bf16: bool = True
    shared_prefix: bool = True
    max_new_tokens: int = 300
    decode_unroll: Optional[int] = None
    seed: int = 42
    device: str = "cuda"


class RaDialogPipeline:
    """Vision encoder, Q-Former, findings classifier and W8A8 Vicuna with
    the int8-KV decode engine, on ``cfg.device``."""

    def __init__(self, cfg: PipelineConfig):
        if cfg.mock == cfg.synthetic:
            raise ValueError("choose mock=True or synthetic=True: loading real "
                             "checkpoints is not ported yet")
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda":
            set_precision()
        self.policy: DTypePolicy = BF16 if cfg.bf16 and not cfg.mock else FP32
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        dev = self.device
        if cfg.mock:
            self.llama_cfg = dataclasses.replace(
                TINY_LLAMA, num_img_tokens=32, max_position=512,
                qformer_dim=TINY_QFORMER.bert.hidden_size)
            host_gen = torch.Generator().manual_seed(cfg.seed)
            self.llama = quantize_llama_host(llama_init(host_gen, self.llama_cfg), device=dev)
            self.qformer_cfg = dataclasses.replace(TINY_QFORMER, num_query_tokens=32)
            lora_dtype = torch.float32
        else:
            self.llama_cfg = VICUNA_7B
            self.llama = random_serving_params(self.llama_cfg, gen, device=dev)
            self.qformer_cfg = QFormerConfig()
            lora_dtype = torch.bfloat16
        self.tokenizer = WhitespaceTokenizer(vocab_size=self.llama_cfg.vocab_size,
                                             num_img_tokens=self.llama_cfg.num_img_tokens,
                                             img_token_id=self.llama_cfg.img_token_id)
        self.lora = lora_init(gen, self.llama_cfg, device=dev, dtype=lora_dtype)
        self.blip2 = {"qformer": qformer_init(gen, self.qformer_cfg, dev),
                      "ln_vision": layernorm_init(self.qformer_cfg.encoder_width, dev)}
        self.visual, self.visual_state = biovil_t_init(
            gen, dev, joint_feature_size=self.qformer_cfg.encoder_width)
        self.classifier, self.classifier_state = chexpert_classifier_init(gen, dev)

    def to(self, device) -> "RaDialogPipeline":
        """Move every parameter to ``device`` (the same weights on another
        device, e.g. a CPU-built reference moved to the card)."""
        def move(tree):
            if isinstance(tree, dict):
                return {k: move(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(move(v) for v in tree)
            return tree.to(device)   # tensors and PackedQ8
        self.device = torch.device(device)
        if self.device.type == "cuda":
            set_precision()
        for name in ("llama", "lora", "blip2", "visual", "visual_state",
                     "classifier", "classifier_state"):
            setattr(self, name, move(getattr(self, name)))
        return self

    # ------------------------------------------------------------ vision
    @torch.no_grad()
    def embed_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B,448,448,3) float [0,1] -> Q-Former query embeddings (B,32,768)."""
        out = biovil_t_apply(self.visual, self.visual_state, images.to(self.device),
                             policy=self.policy)
        patch = patch_tokens_for_qformer(out.projected_patch_embeddings)
        patch = layernorm(self.blip2["ln_vision"], patch)
        return blip2_forward_image(self.blip2, Blip2Config(qformer=self.qformer_cfg),
                                   patch, policy=self.policy)

    @torch.no_grad()
    def classify_findings(self, images_488: torch.Tensor) -> List[List[str]]:
        """(B,488,488,3) -> positive finding names per image."""
        logits = chexpert_classifier_apply(self.classifier, self.classifier_state,
                                           images_488.to(self.device), policy=self.policy)
        mask = predicted_findings(logits).cpu().numpy()
        return [[CHEXPERT_CLASSES[j] for j in range(len(CHEXPERT_CLASSES)) if row[j]]
                for row in mask]

    # ------------------------------------------------------------ generate
    def _shared_prefix_len(self, ids: List[List[int]],
                           img_embs: Optional[torch.Tensor]) -> Tuple[int, bool]:
        """Longest common token prefix usable for prefix sharing: capped at
        min_len - 1 and before the first <IMG> unless every lane carries the
        same image embeddings (then the whole <IMG> run may join it).
        Returns (p0, img_in_prefix)."""
        if not self.cfg.shared_prefix or len(ids) < 2:
            return 0, False
        first = ids[0]
        p0 = min(len(s) for s in ids)
        for s in ids[1:]:
            i = 0
            while i < p0 and s[i] == first[i]:
                i += 1
            p0 = i
        p0 = min(p0, min(len(s) for s in ids) - 1)
        img_in_prefix = False
        img_id = self.llama_cfg.img_token_id
        if img_embs is not None and any(img_id in s for s in ids):
            img_cap = min(s.index(img_id) for s in ids if img_id in s)
            same_image = bool(torch.all(img_embs == img_embs[:1]))
            if same_image and p0 >= img_cap + self.llama_cfg.num_img_tokens:
                img_in_prefix = True
            else:
                p0 = min(p0, img_cap)
        return p0, img_in_prefix

    @torch.no_grad()
    def generate_ids(self, ids: List[List[int]], img_embs: Optional[torch.Tensor],
                     dp: DecodeParams) -> GenerationResult:
        """Token ids of each prompt -> greedy generation (shared-prefix
        serving when the batch's common prefix is long enough)."""
        pad = self.tokenizer.pad_token_id
        sp = self._shared_prefix_len(ids, img_embs)
        if sp[0] >= SHARED_PREFIX_MIN:
            p0, img_in_prefix = sp
            tokens, lengths = pad_batch_right([s[p0:] for s in ids], pad)
            return generate_shared_prefix(
                self.llama, self.llama_cfg,
                torch.as_tensor(np.asarray(ids[0][:p0], np.int32), device=self.device),
                torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(lengths, device=self.device), dp,
                img_embs=None if img_in_prefix else img_embs,
                prefix_img_embs=img_embs[:1] if img_in_prefix else None,
                lora=self.lora, policy=self.policy)
        tokens, lengths = pad_batch_right(ids, pad)
        return generate(self.llama, self.llama_cfg, torch.as_tensor(tokens, device=self.device),
                        torch.as_tensor(lengths, device=self.device), dp,
                        img_embs=img_embs, lora=self.lora, policy=self.policy)

    def decode_params(self, max_new_tokens: Optional[int] = None,
                      eos_token_id: Optional[int] = None) -> DecodeParams:
        unroll = self.cfg.decode_unroll if self.cfg.decode_unroll is not None \
            else (3 if not self.cfg.mock else 1)
        if unroll < 1:
            raise ValueError(f"decode_unroll must be >= 1, got {unroll}")
        return DecodeParams(max_new_tokens=max_new_tokens or self.cfg.max_new_tokens,
                            eos_token_id=(self.tokenizer.eos_token_id if eos_token_id is None
                                          else eos_token_id),
                            seed=self.cfg.seed, unroll=unroll)

    def generate_texts(self, prompts: Sequence[str],
                       img_embs: Optional[torch.Tensor] = None,
                       max_new_tokens: Optional[int] = None) -> List[str]:
        """Tokenize -> prefill -> greedy decode -> prompt + generated text."""
        ids = [self.tokenizer(p)["input_ids"] for p in prompts]
        res = self.generate_ids(ids, img_embs, self.decode_params(max_new_tokens))
        gen = res.tokens.cpu().numpy()
        lens = res.lengths.cpu().numpy()
        return [p + " " + self.tokenizer.decode(gen[i][:int(lens[i])], skip_special_tokens=True)
                for i, p in enumerate(prompts)]
