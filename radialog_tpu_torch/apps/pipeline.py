"""The serving subset of the RaDialog pipeline (port of
radialog_tpu/apps/pipeline.py ``RaDialogPipeline``).

Covered: mock construction (tiny seeded models, real interface contract:
32 <IMG> slots, 32 queries) and synthetic full-width construction (Vicuna-7B,
BioViL-T, BERT-base Q-Former, the CheXpert classifier and the BERT-base
CheXbert labeler with random weights from a seeded ``torch.Generator``),
both with W8A8 weights (or, with ``weight_bits=4``, W4A8 layers) and the
int8 KV cache; ``embed_images``, ``classify_findings``, ``label_reports``,
the shared-prefix rule, greedy ``generate_texts`` (the engine's ``prefill``
picks the direct or the cache-free prefill by batch size) and
``generate_texts_ring`` through the continuous-batching ring with either KV
dtype. Loading real checkpoints, beams and the speculative ring are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..decode.engine import (DecodeParams, GenerationResult, generate,
                             generate_shared_prefix)
from ..models.bert import BertConfig
from ..models.biovil_t import biovil_t_apply, biovil_t_init, patch_tokens_for_qformer
from ..models.blip2 import Blip2Config, blip2_forward_image
from ..models.chexbert import chexbert_apply, chexbert_init, logits_to_labels
from ..models.chexpert import (CHEXPERT_CLASSES, chexpert_classifier_apply,
                               chexpert_classifier_init, predicted_findings)
from ..models.llama import TINY_LLAMA, VICUNA_7B, llama_init, lora_init
from ..models.qformer import QFormerConfig, TINY_QFORMER, qformer_init
from ..ops.layers import BF16, DTypePolicy, FP32, layernorm, layernorm_init, set_precision
from ..ops.quant import quantize_llama_host, random_serving_params
from .tokenization import WhitespaceTokenizer, pad_batch_right

# shortest common prefix worth a separate prefix prefill (as in the JAX package)
SHARED_PREFIX_MIN = 16
MOCK_CHEXBERT = BertConfig(vocab_size=512, hidden_size=32, num_layers=2, num_heads=4,
                           intermediate_size=64, max_position=128)


@dataclasses.dataclass
class PipelineConfig:
    mock: bool = False              # tiny seeded models
    synthetic: bool = False         # full widths, random weights
    bf16: bool = True
    kv_int8: Optional[bool] = None  # None: the serving default, int8
    weight_bits: int = 8            # 4: W4A8 nibble-packed layers (ops/q4_matmul.py), opt-in
    shared_prefix: bool = True
    max_new_tokens: int = 300
    decode_unroll: Optional[int] = None
    seed: int = 42
    device: str = "cuda"

    def use_kv_int8(self) -> bool:
        """The pipeline's weights are always the quantized serving layout,
        so the int8 cache is the default; an explicit False keeps bf16."""
        return self.kv_int8 is None or bool(self.kv_int8)

    def __post_init__(self):
        if self.weight_bits not in (4, 8):
            raise ValueError(f"weight_bits must be 4 or 8, got {self.weight_bits}")


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
            self.llama = quantize_llama_host(llama_init(host_gen, self.llama_cfg, device="cpu"),
                                             device=dev, bits=cfg.weight_bits)
            self.qformer_cfg = dataclasses.replace(TINY_QFORMER, num_query_tokens=32)
            lora_dtype = torch.float32
        else:
            self.llama_cfg = VICUNA_7B
            self.llama = random_serving_params(self.llama_cfg, gen, device=dev,
                                               bits=cfg.weight_bits)
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
        self.chexbert_cfg = MOCK_CHEXBERT if cfg.mock else BertConfig()
        self.chexbert = chexbert_init(gen, self.chexbert_cfg, dev)
        self.bert_tokenizer = WhitespaceTokenizer(vocab_size=self.chexbert_cfg.vocab_size)

    def to(self, device) -> "RaDialogPipeline":
        """Move every parameter to ``device`` (the same weights on another
        device, e.g. a CPU-built reference moved to the card)."""
        def move(tree):
            if isinstance(tree, dict):
                return {k: move(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(move(v) for v in tree)
            return tree.to(device)   # tensors, PackedQ8 and PackedQ4
        self.device = torch.device(device)
        if self.device.type == "cuda":
            set_precision()
        for name in ("llama", "lora", "blip2", "visual", "visual_state",
                     "classifier", "classifier_state", "chexbert"):
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

    # ------------------------------------------------------------ labeling
    @torch.no_grad()
    def label_reports(self, texts: Sequence[str], batch_size: int = 16) -> np.ndarray:
        """CheXbert labels (N, 14) in {nan, 1, 0, -1}, CHEXBERT_CONDITIONS
        order. Texts are cut to the labeler's max_position (512 at BERT-base,
        as the JAX package cuts them)."""
        max_len = min(512, self.chexbert_cfg.max_position)
        out = []
        for i in range(0, len(texts), batch_size):
            ids = [self.bert_tokenizer(t, truncation=True, max_length=max_len)["input_ids"]
                   for t in texts[i:i + batch_size]]
            toks, lengths = pad_batch_right(ids, 0)
            mask = (np.arange(toks.shape[1])[None] < lengths[:, None]).astype(np.int32)
            logits = chexbert_apply(self.chexbert, self.chexbert_cfg,
                                    torch.as_tensor(toks, device=self.device),
                                    torch.as_tensor(mask, device=self.device),
                                    policy=self.policy)
            out.append(logits_to_labels([lg.cpu().numpy() for lg in logits]))
        return np.concatenate(out, axis=0)

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
        if not self.cfg.use_kv_int8():
            raise NotImplementedError("the batch engine's bf16 KV cache is not ported; "
                                      "generate_texts_ring serves kv_int8=False")
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

    def generate_texts_ring(self, prompts: Sequence[str],
                            max_new_tokens: Optional[int] = None, lanes: int = 12,
                            steps_per_call: int = 4,
                            img_embs: Optional[torch.Tensor] = None,
                            spec_k: Optional[int] = None) -> List[str]:
        """``generate_texts`` through the continuous-batching ring
        (decode/continuous.RingBatcher) instead of one fixed batch: requests
        of very different prompt lengths stream through shared lanes. Same
        greedy numerics; outputs in the order of ``prompts``. img_embs:
        (len(prompts), n_img, qformer_dim), spliced at each prompt's <IMG>
        run at admission. The cache dtype follows ``cfg.kv_int8``."""
        if spec_k is not None:
            raise NotImplementedError("batched speculation (decode/spec_ring.py) is not "
                                      "ported yet")
        from ..decode.continuous import RingBatcher
        ids = [self.tokenizer(p)["input_ids"] for p in prompts]
        max_new = max_new_tokens or self.cfg.max_new_tokens
        tpad = max(-(-max(len(x) for x in ids) // 32) * 32, 32)
        nv = -(-max(max_new - 1, 1) // steps_per_call) * steps_per_call + steps_per_call
        dp = DecodeParams(max_new_tokens=max_new, eos_token_id=self.tokenizer.eos_token_id,
                          seed=self.cfg.seed)
        # the ring must exceed a session's chunk-rounded span
        ring = max(-(-nv // 32) * 32, 64)
        rb = RingBatcher(self.llama, self.llama_cfg, lanes=min(lanes, len(ids)),
                         cache_len=tpad + ring, prompt_len=tpad, dp=dp, lora=self.lora,
                         policy=self.policy, steps_per_call=steps_per_call,
                         kv_int8=self.cfg.use_kv_int8(), device=self.device)
        embs = None
        if img_embs is not None:
            e = img_embs.to(self.device)
            embs = e.reshape(len(ids), 1, *e.shape[-2:])
        sids = [rb.submit(x, img_embs=None if embs is None else embs[i])
                for i, x in enumerate(ids)]
        done = rb.run()
        out = []
        eos = self.tokenizer.eos_token_id
        for p, sid in zip(prompts, sids):
            toks = done[sid].tokens
            if eos in toks:
                toks = toks[:toks.index(eos) + 1]
            out.append(p + " " + self.tokenizer.decode(np.asarray(toks, np.int32),
                                                       skip_special_tokens=True))
        return out
