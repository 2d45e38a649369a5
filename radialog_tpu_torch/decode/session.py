"""Interactive multi-turn serving with a persistent KV cache (port of
radialog_tpu/decode/session.py ``InteractiveSession``).

One conversation keeps one cache across turns: turn 1 prefills its prompt
(with the <IMG> splice) into slots [0, t1), the reply's decode writes the
next slots, and each later turn prefills only its own new tokens at the
current offset, so a turn costs its new tokens, not the conversation.
Slots are absolute positions. Appended turns are padded to multiples of 16
tokens; the padding's KV sits past ``cur_len``, is never unmasked and is
overwritten by the next writes.

The incremental prefill on the unrolled serving params goes through
``llama_apply(verify=True)``, which attends the cached history (the direct
prefill would attend only the appended block); the stacked layout attends
the whole cache for any block and ignores the flag. The cache is the bf16
one, as JAX's ``init_cache(cfg, 1, cache_len)`` gives (the port's
``init_cache`` defaults to int8, so the session asks for ``quantized=False``)
and it is written in place: the decode is the engine's ``decode_loop`` with
prompt_pad = the current length. The JAX package jits one program per shape
and donates the cache; ``warmup`` here runs the same throwaway conversation
so that the first user's turn finds cuBLAS plans and the allocator's pool
made.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from ..models.llama import LlamaConfig, find_img_start, init_cache, llama_apply
from ..ops.attention import causal_mask_bias
from ..ops.layers import DTypePolicy, FP32
from .engine import DecodeParams, decode_loop, decode_step
from .speculative import spec_decode_loop


class InteractiveSession:
    """One conversation's LLM state: the cache and its current length."""

    def __init__(self, params: Dict, cfg: LlamaConfig, lora: Optional[Dict] = None,
                 policy: DTypePolicy = FP32, cache_len: int = 2048, device="cuda"):
        self.params, self.cfg, self.lora, self.policy = params, cfg, lora, policy
        self.cache_len = cache_len
        self.device = torch.device(device)
        self.reset()

    def reset(self) -> None:
        self.cache = init_cache(self.cfg, 1, self.cache_len, device=self.device,
                                quantized=False)
        self.cur_len = 0
        self.token_ids: List[int] = []
        self._last_logits = None
        # the decode never feeds the FINAL generated token through the model;
        # it is prepended to the next append
        self._pending_tail: List[int] = []

    @property
    def remaining(self) -> int:
        return self.cache_len - self.cur_len

    def warmup(self, dp: DecodeParams, turn_lengths=(16,), spec_k: int = 0,
               token_id: int = 0) -> float:
        """Run a throwaway conversation (one append per entry of
        ``turn_lengths``, a decode with ``dp``, and with spec_k > 0 the
        speculative loop), then reset. Returns the seconds spent."""
        t0 = time.time()
        for tl in turn_lengths:
            self.reset()
            self.append_tokens([token_id] * max(1, int(tl)))
            if spec_k > 0:
                self.generate_spec(dp, k=spec_k)
                self.reset()
                self.append_tokens([token_id] * max(1, int(tl)))
            self.generate(dp)
        self.reset()
        return time.time() - t0

    @torch.no_grad()
    def append_tokens(self, ids: List[int], img_embs: Optional[torch.Tensor] = None) -> None:
        """Feed new prompt tokens (a first prompt, or a later turn's delta)
        through an incremental prefill at the current offset."""
        ids = self._pending_tail + list(ids)
        self._pending_tail = []
        if not ids:
            return
        tn = len(ids)
        padded = ids + [self.cfg.pad_token_id] * ((-tn) % 16)
        t = len(padded)
        if self.cur_len + t > self.cache_len:
            raise ValueError(f"conversation overflow: {self.cur_len}+{t} > {self.cache_len}")
        tokens = torch.tensor([padded], dtype=torch.int32, device=self.device)
        img_start = (find_img_start(tokens, self.cfg.img_token_id)
                     if img_embs is not None else None)
        logits, _ = llama_apply(
            self.params, self.cfg, tokens,
            self.cur_len + torch.arange(t, device=self.device)[None],
            causal_mask_bias(t, self.cache_len, offset=self.cur_len, device=self.device),
            cache=self.cache, write_pos=self.cur_len, img_embs=img_embs, img_start=img_start,
            lora=self.lora, policy=self.policy,
            last_pos=torch.full((1,), tn - 1, device=self.device),
            verify=isinstance(self.params["layers"], (list, tuple)))
        self._last_logits = logits[:, 0]
        self.cur_len += tn
        self.token_ids.extend(ids)

    @torch.no_grad()
    def feed_pending(self) -> None:
        """Feed the reply's pending last token through one decode step at
        the current offset, as an uninterrupted decode feeds it (the same
        position, mask and row count), so the next ``generate`` continues
        bitwise that decode. ``append_tokens([])`` would feed it as a
        16-row prefill block, whose bf16 GEMMs round apart from the decode
        step's single row."""
        if len(self._pending_tail) != 1:
            self.append_tokens([])
            return
        tok = self._pending_tail.pop()
        if self.cur_len + 1 > self.cache_len:
            raise ValueError(f"conversation overflow: {self.cur_len}+1 > {self.cache_len}")
        lens = torch.full((1,), self.cur_len, dtype=torch.int32, device=self.device)
        self._last_logits = decode_step(
            self.params, self.cfg, self.cache,
            torch.tensor([tok], dtype=torch.int32, device=self.device), lens, self.cur_len, 0,
            lora=self.lora, policy=self.policy)
        self.cur_len += 1
        self.token_ids.append(tok)

    def _commit(self, res, eos: int) -> List[int]:
        """Take a reply: KV is written for all its tokens but the last,
        which stays pending unless it is eos (the next turn's text
        re-tokenizes the separator)."""
        n = int(res.lengths[0])
        new_ids = res.tokens[0, :n].tolist()
        written = max(n - 1, 0)
        self.cur_len += written
        self.token_ids.extend(new_ids[:written])
        self._pending_tail = [t for t in new_ids[written:] if t != eos]
        self._last_logits = None
        return new_ids

    @torch.no_grad()
    def generate(self, dp: DecodeParams) -> List[int]:
        """Decode a reply continuing the cached conversation; its tokens' KV
        stays in the cache for the next turn."""
        if self._last_logits is None:
            raise RuntimeError("append_tokens must run before generate")
        headroom = max(0, dp.unroll - 2)     # JAX's phantom sub-steps, kept as its bound
        if self.cur_len + dp.max_new_tokens + headroom > self.cache_len:
            raise ValueError(f"conversation overflow: {self.cur_len}+{dp.max_new_tokens}"
                             f"+{headroom} (unroll phantom headroom) > {self.cache_len}")
        lens = torch.full((1,), self.cur_len, dtype=torch.int32, device=self.device)
        res = decode_loop(self.params, self.cfg, self.cache, self._last_logits, lens, dp,
                          lora=self.lora, policy=self.policy, prompt_pad=self.cur_len)
        return self._commit(res, dp.eos_token_id)

    @torch.no_grad()
    def generate_spec(self, dp: DecodeParams, k: int = 4, m: int = 3) -> List[int]:
        """``generate`` with prompt-lookup speculative decoding
        (decode/speculative.py): drafts matched from the conversation's
        history, one (k+1)-token verify forward per iteration."""
        if self._last_logits is None:
            raise RuntimeError("append_tokens must run before generate_spec")
        if self.cur_len + dp.max_new_tokens + k + 1 > self.cache_len:
            raise ValueError("conversation overflow")
        if k + 1 > 16:
            # the last verify block can leave up to k - 1 stale rows past
            # cur_len; the next 16-bucketed append overwrites them first
            raise ValueError("session speculative decode supports k <= 15")
        hist = torch.full((self.cache_len,), -1, dtype=torch.int32, device=self.device)
        hist[:self.cur_len] = torch.tensor(self.token_ids, dtype=torch.int32)
        res, _ = spec_decode_loop(self.params, self.cfg, self.cache, self._last_logits,
                                  self.cur_len, dp, k, m, hist, lora=self.lora,
                                  policy=self.policy)
        return self._commit(res, dp.eos_token_id)
