"""The RaDialog pipeline (port of radialog_tpu/apps/pipeline.py
``RaDialogPipeline``).

Three ways to build it: ``mock`` (tiny seeded models, real interface
contract: 32 <IMG> slots, 32 queries), ``synthetic`` (full widths, random
weights from a seeded ``torch.Generator``) or, as in the JAX package, from
checkpoint files: ``vicuna_path`` (an HF directory of safetensors or
``pytorch_model*.bin`` shards, with the tokenizer), ``lora_path`` (PEFT
``adapter_model.bin``, ``adapter_config.json`` beside it), ``blip2_checkpoint``
(the stage-1 ``.pth``, with BioViL-T under ``visual_encoder.``),
``classifier_checkpoint`` (the Lightning ``.ckpt``), ``chexbert_checkpoint``
and ``emb_cache`` (an npz of query embeddings by dicom id). A component
without a checkpoint keeps its seeded init, as in JAX. The LLaMA is quantized
(``quantize=True``, the port's default: W8A8 weights or, with
``weight_bits=4``, W4A8 layers, and the int8 KV cache or, with
``kv_int8=False``, the bf16 one) or float (``quantize=False``, the JAX
package's default: ``llama_init``'s stacked tree in the policy's dtype, f32
for the mock and bf16 otherwise, over the bf16 cache, with no prefix
sharing). ``embed_images`` (cache hits first), ``classify_findings``,
``label_reports``, the shared-prefix rule, ``generate_texts`` (greedy,
sampled, or beam search with ``num_beams > 1``, decode/beam.py) and
``generate_texts_ring`` through the continuous-batching ring, or with
``spec_k`` through batched speculation (decode/spec_ring.py
``SpecCompactBatcher``).
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..decode.beam import generate_beam
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
from ..utils import hf_weights
from . import tokenization
from .tokenization import WhitespaceTokenizer, pad_batch_right

# shortest common prefix worth a separate prefix prefill (as in the JAX package)
SHARED_PREFIX_MIN = 16
MOCK_CHEXBERT = BertConfig(vocab_size=512, hidden_size=32, num_layers=2, num_heads=4,
                           intermediate_size=64, max_position=128)


@dataclasses.dataclass
class PipelineConfig:
    vicuna_path: Optional[str] = None        # HF dir with tokenizer + weights
    lora_path: Optional[str] = None          # adapter_model.bin
    blip2_checkpoint: Optional[str] = None   # stage-1 .pth
    classifier_checkpoint: Optional[str] = None  # Lightning .ckpt
    chexbert_checkpoint: Optional[str] = None
    bert_tokenizer_path: Optional[str] = None
    emb_cache: Optional[str] = None          # npz: dicom -> (32, 768)
    mock: bool = False              # tiny seeded models
    synthetic: bool = False         # full widths, random weights
    bf16: bool = True
    # W8A8 serving weights. True here, the reverse of the JAX package's
    # default: chip_smoke.py, the tools and most tests build the quantized
    # pipeline without naming it. False: the float path
    quantize: bool = True
    kv_int8: Optional[bool] = None  # None: int8 with quantize, else bf16
    weight_bits: int = 8            # 4: W4A8 nibble-packed layers (ops/q4_matmul.py), opt-in
    shared_prefix: bool = True
    max_new_tokens: int = 300
    decode_unroll: Optional[int] = None
    seed: int = 42
    device: str = "cuda"

    def use_kv_int8(self) -> bool:
        """The int8 cache by default on the quantized path; an explicit
        False keeps bf16. The float path's stacked layout has no int8 cache."""
        if self.kv_int8:
            if not self.quantize:
                raise ValueError("kv_int8=True requires quantize=True: the int8 KV cache "
                                 "runs on the unrolled quantize_llama_host serving params")
            return True
        return self.quantize if self.kv_int8 is None else False

    def __post_init__(self):
        if self.weight_bits not in (4, 8):
            raise ValueError(f"weight_bits must be 4 or 8, got {self.weight_bits}")
        if self.weight_bits != 8 and not self.quantize:
            raise ValueError("weight_bits=4 requires quantize=True (the W4A8 path runs on "
                             "the unrolled quantize_llama_host serving params)")


def move_tree(tree, device, dtype=None):
    """Every leaf of a tree of dicts, lists and tuples moved to ``device``
    (tensors, PackedQ8 and PackedQ4), tensors also cast to ``dtype``; None
    stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: move_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(move_tree(v, device, dtype) for v in tree)
    return tree.to(device) if dtype is None else tree.to(device, dtype)


class RaDialogPipeline:
    """Vision encoder, Q-Former, findings classifier and Vicuna (W8A8 or
    W4A8 serving params, or the stacked float tree) with the decode engine,
    on ``cfg.device``."""

    def __init__(self, cfg: PipelineConfig):
        if cfg.mock and cfg.synthetic:
            raise ValueError("choose one of mock=True and synthetic=True")
        real = not (cfg.mock or cfg.synthetic)
        if real and cfg.vicuna_path is None:
            raise ValueError("vicuna_path required (or use mock=True)")
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda":
            set_precision()
        self.policy: DTypePolicy = BF16 if cfg.bf16 and not cfg.mock else FP32
        # seconds of the checkpoint load by stage (read, convert, to_card)
        self.load_seconds: Dict[str, float] = {}
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        dev = self.device
        dtype = torch.bfloat16 if self.policy is BF16 else torch.float32
        if cfg.mock:
            self.llama_cfg = dataclasses.replace(
                TINY_LLAMA, num_img_tokens=32, max_position=512,
                qformer_dim=TINY_QFORMER.bert.hidden_size)
            # the same float weights on both paths, drawn on the host
            host_gen = torch.Generator().manual_seed(cfg.seed)
            base = llama_init(host_gen, self.llama_cfg, device="cpu")
            self.llama = (quantize_llama_host(base, device=dev, bits=cfg.weight_bits)
                          if cfg.quantize else move_tree(base, dev, dtype))
            self.qformer_cfg = dataclasses.replace(TINY_QFORMER, num_query_tokens=32)
        else:
            self.llama_cfg = VICUNA_7B
            if real:
                self.llama = self._load_llama(cfg.vicuna_path, dtype)
            elif cfg.quantize:
                self.llama = random_serving_params(self.llama_cfg, gen, device=dev,
                                                   bits=cfg.weight_bits)
            else:
                # drawn on the device: llama_init's f32 transient of one
                # stacked leaf is at most 32 x 4096 x 11008 x 4 B = 5.8 GB
                self.llama = llama_init(gen, self.llama_cfg, device=dev, dtype=dtype)
            self.qformer_cfg = QFormerConfig()
        self.tokenizer = (tokenization.load_vicuna_tokenizer(cfg.vicuna_path) if real else
                          WhitespaceTokenizer(vocab_size=self.llama_cfg.vocab_size,
                                              num_img_tokens=self.llama_cfg.num_img_tokens,
                                              img_token_id=self.llama_cfg.img_token_id))
        self.lora = (self._load_lora(cfg.lora_path, dtype) if real and cfg.lora_path
                     else lora_init(gen, self.llama_cfg, device=dev, dtype=dtype))
        if real and cfg.blip2_checkpoint:
            self.blip2, vis_state = self._load_blip2(cfg.blip2_checkpoint)
            self.visual = self.blip2.get("visual")
            self.visual_state = vis_state.get("visual")
        else:
            self.blip2 = {"qformer": qformer_init(gen, self.qformer_cfg, dev),
                          "ln_vision": layernorm_init(self.qformer_cfg.encoder_width, dev)}
            self.visual, self.visual_state = biovil_t_init(
                gen, dev, joint_feature_size=self.qformer_cfg.encoder_width)
        if real and cfg.classifier_checkpoint:
            sd = hf_weights._torch_load(cfg.classifier_checkpoint)
            self.classifier, self.classifier_state = (
                move_tree(t, dev, torch.float32) for t in
                hf_weights.convert_chexpert_classifier(sd.get("state_dict", sd)))
        else:
            self.classifier, self.classifier_state = chexpert_classifier_init(gen, dev)
        self.chexbert_cfg = MOCK_CHEXBERT if cfg.mock else BertConfig()
        if real and cfg.chexbert_checkpoint:
            sd = hf_weights._torch_load(cfg.chexbert_checkpoint)
            sd = sd.get("model_state_dict", sd.get("state_dict", sd))
            self.chexbert = move_tree(hf_weights.convert_chexbert(sd), dev, torch.float32)
            self.bert_tokenizer = tokenization.load_bert_tokenizer(cfg.bert_tokenizer_path)
        else:
            self.chexbert = chexbert_init(gen, self.chexbert_cfg, dev)
            self.bert_tokenizer = WhitespaceTokenizer(vocab_size=self.chexbert_cfg.vocab_size)
        self.emb_cache: Dict[str, np.ndarray] = {}
        if cfg.emb_cache and Path(cfg.emb_cache).exists():
            self.emb_cache = dict(np.load(cfg.emb_cache))

    # ------------------------------------------------------------- loaders
    def _load_llama(self, path: str, dtype) -> Dict:
        """The HF checkpoint of ``path`` -> W8A8 / W4A8 serving params
        (``quantize_llama_host``, W8A8 packed on the device) or the stacked
        tree in ``dtype``, built one layer at a time from views of the
        state dict, so the host holds the checkpoint once. Stage seconds go
        to ``load_seconds``: read, convert, and to_card (the quantized
        path's pack included)."""
        t0 = time.perf_counter()
        sd = hf_weights._load_hf_state_dict(path)
        t1 = time.perf_counter()
        params = hf_weights.convert_llama(sd, VICUNA_7B.num_layers, stack=False)
        del sd
        t2 = time.perf_counter()
        if self.cfg.quantize:
            out = quantize_llama_host(params, device=self.device, bits=self.cfg.weight_bits)
        else:
            out = move_tree({k: v for k, v in params.items() if k != "layers"},
                            self.device, dtype)
            out["layers"] = hf_weights.stack_layers(params["layers"], self.device, dtype)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_seconds = {"read": t1 - t0, "convert": t2 - t1,
                             "to_card": time.perf_counter() - t2}
        return out

    def _load_lora(self, path: str, dtype) -> Dict:
        """PEFT adapter -> the LoRA tree in ``dtype`` (its scale too, as in
        JAX); rank and alpha from the ``adapter_config.json`` beside it."""
        acfg = None
        cfg_path = Path(path).parent / "adapter_config.json"
        if cfg_path.exists():
            acfg = json.loads(cfg_path.read_text())
        lora = hf_weights.convert_peft_lora(hf_weights._torch_load(path),
                                            self.llama_cfg.num_layers, adapter_config=acfg)
        return move_tree(lora, self.device, dtype)

    def _load_blip2(self, path: str) -> Tuple[Dict, Dict]:
        ckpt = hf_weights._torch_load(path)
        params, state = hf_weights.convert_blip2(ckpt.get("model", ckpt))
        return move_tree(params, self.device, torch.float32), move_tree(state, self.device,
                                                                        torch.float32)

    def to(self, device) -> "RaDialogPipeline":
        """Move every parameter to ``device`` (the same weights on another
        device, e.g. a CPU-built reference moved to the card)."""
        self.device = torch.device(device)
        if self.device.type == "cuda":
            set_precision()
        for name in ("llama", "lora", "blip2", "visual", "visual_state",
                     "classifier", "classifier_state", "chexbert"):
            setattr(self, name, move_tree(getattr(self, name), device))
        return self

    # ------------------------------------------------------------ vision
    @torch.no_grad()
    def embed_images(self, images: torch.Tensor,
                     dicoms: Optional[Sequence[str]] = None) -> torch.Tensor:
        """(B,448,448,3) float [0,1] -> Q-Former query embeddings (B,32,768);
        the rows of ``emb_cache`` instead when every one of ``dicoms`` is
        there."""
        if dicoms is not None and self.emb_cache:
            hits = [self.emb_cache.get(str(d)) for d in dicoms]
            if all(h is not None for h in hits):
                return torch.as_tensor(np.stack(hits), device=self.device)
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
        order. Texts are cut at 512 tokens, as the JAX package cuts them;
        where the labeler has fewer positions (the mock's 128), the tokens
        past them read its last position row (``bert_embeddings``)."""
        out = []
        for i in range(0, len(texts), batch_size):
            ids = [self.bert_tokenizer(t, truncation=True, max_length=512)["input_ids"]
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
        same image embeddings (then the whole <IMG> run may join it); 0 on
        the float path, whose stacked layout shares no prefix, as in the JAX
        package. Returns (p0, img_in_prefix)."""
        if not self.cfg.shared_prefix or not self.cfg.quantize or len(ids) < 2:
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
        """Token ids of each prompt -> generation (shared-prefix serving
        when the batch's common prefix is long enough), over the KV cache
        that ``cfg.kv_int8`` picks."""
        kv_int8 = self.cfg.use_kv_int8()
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
                lora=self.lora, policy=self.policy, kv_int8=kv_int8)
        tokens, lengths = pad_batch_right(ids, pad)
        return generate(self.llama, self.llama_cfg, torch.as_tensor(tokens, device=self.device),
                        torch.as_tensor(lengths, device=self.device), dp,
                        img_embs=img_embs, lora=self.lora, policy=self.policy, kv_int8=kv_int8)

    def decode_params(self, max_new_tokens: Optional[int] = None,
                      eos_token_id: Optional[int] = None, do_sample: bool = False,
                      temperature: float = 1.0) -> DecodeParams:
        unroll = self.cfg.decode_unroll if self.cfg.decode_unroll is not None \
            else (3 if self.cfg.quantize and not self.cfg.mock else 1)
        if unroll < 1:
            raise ValueError(f"decode_unroll must be >= 1, got {unroll}")
        return DecodeParams(max_new_tokens=max_new_tokens or self.cfg.max_new_tokens,
                            eos_token_id=(self.tokenizer.eos_token_id if eos_token_id is None
                                          else eos_token_id),
                            do_sample=do_sample, temperature=temperature,
                            seed=self.cfg.seed, unroll=unroll)

    def generate_texts(self, prompts: Sequence[str],
                       img_embs: Optional[torch.Tensor] = None,
                       max_new_tokens: Optional[int] = None, do_sample: bool = False,
                       temperature: float = 1.0, num_beams: int = 1) -> List[str]:
        """Tokenize -> prefill -> decode (greedy, sampled at ``temperature``
        from the noise of ``cfg.seed``, or beam search over ``num_beams``
        beams on the bf16 cache) -> prompt + generated text."""
        ids = [self.tokenizer(p)["input_ids"] for p in prompts]
        dp = self.decode_params(max_new_tokens, do_sample=do_sample, temperature=temperature)
        if num_beams > 1:
            tokens, lengths = pad_batch_right(ids, self.tokenizer.pad_token_id)
            res = generate_beam(self.llama, self.llama_cfg,
                                torch.as_tensor(tokens, device=self.device),
                                torch.as_tensor(lengths, device=self.device),
                                dataclasses.replace(dp, unroll=1), num_beams=num_beams,
                                img_embs=img_embs, lora=self.lora, policy=self.policy)
        else:
            res = self.generate_ids(ids, img_embs, dp)
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
        run at admission. The cache dtype follows ``cfg.use_kv_int8``; the
        float path runs the bf16 ring on its stacked params. ``spec_k``:
        batched speculation instead (decode/spec_ring.SpecCompactBatcher,
        prompt-lookup drafts verified k+1 wide, accepted rows moved to each
        lane's frontier), the same greedy tokens in fewer forwards where the
        outputs quote their prompts (the correction pass), in a cache of the
        plain decode's size plus k+1 slots, with either cache."""
        from ..decode.continuous import RingBatcher
        from ..decode.spec_ring import SpecCompactBatcher
        ids = [self.tokenizer(p)["input_ids"] for p in prompts]
        max_new = max_new_tokens or self.cfg.max_new_tokens
        tpad = max(-(-max(len(x) for x in ids) // 32) * 32, 32)
        nv = -(-max(max_new - 1, 1) // steps_per_call) * steps_per_call + steps_per_call
        dp = DecodeParams(max_new_tokens=max_new, eos_token_id=self.tokenizer.eos_token_id,
                          seed=self.cfg.seed)
        kw = dict(lanes=min(lanes, len(ids)), prompt_len=tpad, dp=dp, lora=self.lora,
                  policy=self.policy, steps_per_call=steps_per_call,
                  kv_int8=self.cfg.use_kv_int8(), device=self.device)
        if spec_k is not None:
            # the plain decode's cache and k+1 window slots, in multiples of 32
            gen = -(-max(max_new + spec_k + 1, nv + 32) // 32) * 32
            rb = SpecCompactBatcher(self.llama, self.llama_cfg, cache_len=tpad + gen,
                                    spec_k=spec_k, **kw)
        else:
            # the ring must exceed a session's chunk-rounded span
            ring = max(-(-nv // 32) * 32, 64)
            rb = RingBatcher(self.llama, self.llama_cfg, cache_len=tpad + ring, **kw)
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
