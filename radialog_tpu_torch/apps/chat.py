"""Interactive dialog session, the logic behind the demo (port of
radialog_tpu/apps/chat.py ``ChatSession``).

An image turn predicts the findings with the classifier, embeds the image
through the Q-Former and, in report mode, asks for the report; text turns
continue the conversation. The image's embeddings stay on the device and
join the prefill of each turn that holds an <IMG> run. ``load_image`` is the
file decode (PIL) followed by ``image_turn``, which takes the preprocessed
arrays, so that an image already in memory needs no file.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from ..data.conversation import DEMO_SYSTEM, Conversation
from ..data.prompts import IMG_RUN
from ..decode.engine import DecodeParams
from ..decode.session import InteractiveSession
from ..ops.image import preprocess_file
from ..utils.streaming import stream_chunks
from .pipeline import RaDialogPipeline

RG_PROMPT = (
    f"Image information: {IMG_RUN}. Predicted Findings: {{findings}}. You are "
    "to act as a radiologist and write the finding section of a chest x-ray "
    "radiology report for this X-ray image and the given predicted findings. "
    "Write in the style of a radiologist, write one fluent text without "
    "enumeration, be concise and don't provide explanations or reasons.")


class ChatSession:
    """Multi-turn dialog over one (optional) image.

    With ``prefix_cache`` (the default) each turn prefills only its new
    tokens against a persistent KV cache (decode/session.InteractiveSession);
    where the conversation's tokens are not a prefix of the new prompt's
    (after an edit, or a reply that re-tokenizes differently) the whole
    prompt is prefilled again. ``speculative`` decodes replies by
    prompt-lookup speculation with ``spec_k`` drafts (the same tokens)."""

    def __init__(self, pipe: RaDialogPipeline, gen_report: bool = True,
                 precomputed_findings: Optional[Dict[str, List[str]]] = None,
                 prefix_cache: bool = True, cache_len: int = 2048,
                 speculative: bool = False, spec_k: int = 5):
        self.pipe = pipe
        self.gen_report = gen_report
        self.speculative = speculative and prefix_cache
        self.spec_k = spec_k
        self.precomputed = precomputed_findings or {}
        self.conv = Conversation(system=DEMO_SYSTEM)
        self.img_embs: Optional[torch.Tensor] = None
        self.findings: Optional[str] = None
        self.session = None
        if prefix_cache:
            self.session = InteractiveSession(
                pipe.llama, pipe.llama_cfg, lora=pipe.lora, policy=pipe.policy,
                cache_len=min(cache_len, pipe.llama_cfg.max_position), device=pipe.device)

    def reset(self) -> None:
        self.conv = Conversation(system=DEMO_SYSTEM)
        self.img_embs = None
        self.findings = None
        if self.session is not None:
            self.session.reset()

    def _dp(self, max_new: int) -> DecodeParams:
        return DecodeParams(max_new_tokens=max_new, eos_token_id=self.pipe.tokenizer.eos_token_id,
                            seed=self.pipe.cfg.seed)

    def _cap(self) -> int:
        return self.pipe.cfg.max_new_tokens or 300

    def warmup(self, turn_lengths=(16, 128)) -> float:
        """Run the session's throwaway conversation with the decode
        parameters the turns use (the speculative loop too when
        speculative), so that the first user's turn finds the card warm.
        0.0 without a prefix-cache session. Returns the seconds spent."""
        if self.session is None:
            return 0.0
        max_new = max(1, min(self._cap(), self.session.cache_len - 1
                             - (self.spec_k + 1 if self.speculative else 0)))
        return self.session.warmup(self._dp(max_new), turn_lengths=turn_lengths,
                                   spec_k=self.spec_k if self.speculative else 0)

    # ---------------------------------------------------------------- image
    def load_image(self, path: str) -> Tuple[str, Optional[str]]:
        """Image upload turn from a file: decode and preprocess it at 448
        (the Q-Former's) and 488 (the classifier's), then ``image_turn``."""
        return self.image_turn(preprocess_file(path, resize=512, crop=448),
                               preprocess_file(path, resize=512, crop=488), Path(path).stem)

    def image_turn(self, blip_img, cp_img, dicom: str) -> Tuple[str, Optional[str]]:
        """Image upload turn from (448, 448, 3) and (488, 488, 3) float
        images in [0,1] (arrays or tensors): the findings (precomputed for
        ``dicom`` or classified), the image's embeddings, and in report mode
        the report. Returns (reply, findings)."""
        dev = self.pipe.device
        if dicom in self.precomputed:
            findings = ", ".join(self.precomputed[dicom]).lower().strip()
        else:
            names = self.pipe.classify_findings(torch.as_tensor(cp_img, device=dev)[None])[0]
            findings = ", ".join(names).lower().strip()
        self.findings = findings
        self.img_embs = self.pipe.embed_images(torch.as_tensor(blip_img, device=dev)[None],
                                               dicoms=[dicom])
        if not self.gen_report:
            return "", findings
        return self._generate(RG_PROMPT.format(findings=findings)), findings

    # ----------------------------------------------------------------- text
    def ask(self, text: str) -> str:
        """Free-chat or follow-up turn (correction, QA, easy language...)."""
        if text.endswith((".png", ".jpg")):
            return self.load_image(text)[0]
        return self._generate(text)

    def _generate(self, user_text: str) -> str:
        self.conv.append_user(user_text)
        self.conv.append_assistant(None)
        prompt = self.conv.get_prompt()
        if self.session is not None:
            reply = self._generate_incremental(prompt)
        else:
            decoded = self.pipe.generate_texts([prompt], img_embs=self.img_embs,
                                               max_new_tokens=300)[0]
            reply = decoded.split("ASSISTANT:")[-1].strip()
        self.conv.messages.pop()
        self.conv.append_assistant(reply)
        return reply

    def ask_stream(self, text: str, chunk_size: int = 16):
        """``ask`` that yields the reply so far after each decoded chunk of
        ``chunk_size`` tokens (utils/streaming.stream_chunks over the
        persistent cache): greedy, the tokens ``ask`` gives. An image path
        yields its report once."""
        if text.endswith((".png", ".jpg")):
            reply, _ = self.load_image(text)
            if reply:
                yield reply
            return
        if self.session is None:
            yield self._generate(text)
            return
        self.conv.append_user(text)
        self.conv.append_assistant(None)
        self._prefill_incremental(self.conv.get_prompt())
        tok = self.pipe.tokenizer
        cap = max(1, min(self._cap(), self.session.remaining - 1))
        ids: List[int] = []
        for chunk in stream_chunks(self.session, self._dp(cap), chunk_size=chunk_size,
                                   max_new_tokens=cap):
            ids.extend(chunk)
            yield tok.decode(ids, skip_special_tokens=True).strip()
        reply = tok.decode(ids, skip_special_tokens=True).strip()
        self.conv.messages.pop()
        self.conv.append_assistant(reply)

    def _prefill_incremental(self, prompt: str) -> None:
        """Prefill the new prompt's suffix against the session's cache, or
        the whole prompt again where the cached tokens are not its prefix."""
        full_ids = self.pipe.tokenizer(prompt)["input_ids"]
        prev = self.session.token_ids + self.session._pending_tail
        if prev and full_ids[:len(prev)] == prev:
            # the embeddings go with a delta that holds an <IMG> run (a new
            # scan mid-conversation); JAX passes them with every delta, where
            # the splice is a no-op, but fails to trace it for a delta shorter
            # than the run
            delta = full_ids[len(prev):]
            img = self.pipe.llama_cfg.img_token_id in delta
            self.session.append_tokens(delta, img_embs=self.img_embs if img else None)
        else:
            self.session.reset()
            self.session.append_tokens(full_ids, img_embs=self.img_embs)

    def _generate_incremental(self, prompt: str) -> str:
        self._prefill_incremental(prompt)
        if self.speculative:
            # k + 1 slots of headroom for the last verify block
            dp = self._dp(max(1, min(self._cap(), self.session.remaining - self.spec_k - 2)))
            ids = self.session.generate_spec(dp, k=self.spec_k)
        else:
            ids = self.session.generate(self._dp(max(1, min(self._cap(),
                                                            self.session.remaining - 1))))
        return self.pipe.tokenizer.decode(ids, skip_special_tokens=True).strip()
