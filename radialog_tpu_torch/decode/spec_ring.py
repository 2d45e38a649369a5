"""Batched speculative decoding over the ring batcher (port of
radialog_tpu/decode/spec_ring.py ``SpecRingBatcher`` and
``SpecCompactBatcher``).

Each verify drafts k tokens per lane by prompt lookup (decode/speculative.py
``ngram_propose``, over per-lane token histories kept on the device), runs
one (k+1)-token verify forward for all lanes (``llama_apply(verify=True)``)
and accepts per lane the longest prefix of drafts equal to the model's
greedy argmax, plus the model's token at the first mismatch. Every emitted
token is the lane's greedy choice given its context, so each lane's tokens
are the plain ``RingBatcher``'s.

``SpecRingBatcher`` writes every verify's block into one shared (k+1)-slot
window of the generation ring and marks per lane which of its slots hold
accepted rows in the (lanes, S) validity mask, which becomes the attention
bias: the bf16 cache only, since the int8 ring's flash-decode kernel takes
at most two slot intervals a lane. The ring costs k+1 slots per verify
whatever is accepted. ``SpecCompactBatcher`` writes each block into a fixed
(k+1)-slot scratch window at the cache's end and copies each lane's accepted
rows to its contiguous frontier after the verify, so a lane's live rows stay
one interval and either cache works at the plain decode's size plus k+1.

As in the port's ``RingBatcher``, ``steps_per_call`` verifies run between
two admission rounds as a Python loop on the device, read back once; the
cache, the validity mask and the histories are written in place; the
``proposer`` hook takes the whole batch: proposer(hist (lanes, Hmax),
hist_lens (lanes,)) -> drafts (lanes, k) (JAX vmaps a one-lane function).
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.llama import LlamaConfig, llama_apply
from ..ops.layers import DTypePolicy, FP32
from .continuous import NEG, RingBatcher
from .engine import DecodeParams
from .speculative import ngram_propose


class SpecRingBatcher(RingBatcher):
    """RingBatcher whose decode step is a batched speculative verify over
    the bf16 ring; ``steps_per_call`` counts verifies per call, each
    emitting 1..k+1 tokens a lane."""

    _takes_int8 = False     # the int8 ring's kernel masks two slot intervals a lane

    def __init__(self, params: Dict, cfg: LlamaConfig, lanes: int = 4, cache_len: int = 512,
                 prompt_len: int = 256, dp: DecodeParams = DecodeParams(),
                 lora: Optional[Dict] = None, policy: DTypePolicy = FP32,
                 steps_per_call: int = 1, kv_int8: bool = False, spec_k: int = 4,
                 spec_m: int = 3, proposer=None, device="cuda"):
        if kv_int8 and not self._takes_int8:
            raise ValueError(
                "batched speculation on the ring needs the dense validity mask; the int8 "
                "KV kernel's two-interval mask (ops/flash_decode.py gen_intervals) cannot "
                "hold the per-verify acceptance holes: use SpecCompactBatcher")
        if dp.do_sample:
            raise ValueError("speculative verification is greedy-only")
        self.spec_k, self.spec_m, self._proposer = spec_k, spec_m, proposer
        self._check_capacity(cache_len, prompt_len, dp.max_new_tokens, steps_per_call)
        super().__init__(params, cfg, lanes=lanes, cache_len=cache_len, prompt_len=prompt_len,
                         dp=dp, lora=lora, policy=policy, steps_per_call=steps_per_call,
                         kv_int8=kv_int8, device=device)
        # per-lane drafter histories with k+1 columns past cache_len: the
        # per-verify append clamps its start (JAX's dynamic_update_slice), and
        # a lane near capacity must not overwrite its real tail with junk
        self.hist = torch.full((self.lanes, self.cache_len + self.spec_k + 1), -1,
                               dtype=torch.int32, device=self.device)
        self.hist_lens = np.zeros(self.lanes, np.int32)
        self.verifies = 0   # verify forwards run, lanes counted (acceptance telemetry)

    def _check_capacity(self, cache_len: int, prompt_len: int, max_new: int,
                        steps_per_call: int) -> None:
        """The ring is whole windows of k+1 slots, and a session takes k+1
        slots a verify and, accepting nothing, max_new - 1 verifies rounded
        up to whole chunks."""
        kp1 = self.spec_k + 1
        ring_len = cache_len - prompt_len
        if ring_len % kp1:
            raise ValueError(f"ring ({cache_len}-{prompt_len}={ring_len}) must be a multiple "
                             f"of the verify window k+1={kp1} so windows never "
                             f"straddle the wrap")
        nv = -(-max(max_new - 1, 1) // steps_per_call) * steps_per_call
        if nv * kp1 >= ring_len:
            raise ValueError(f"max_new_tokens {max_new} needs {nv} verifies * "
                             f"(k+1)={kp1} slots >= ring {ring_len}: "
                             f"zero-acceptance sessions would wrap onto live KV")

    def validate_request(self, n_prompt_tokens: int,
                         max_new_tokens: Optional[int] = None) -> None:
        super().validate_request(n_prompt_tokens, max_new_tokens)
        self._check_capacity(self.cache_len, self.prompt_len,
                             self.dp.max_new_tokens if max_new_tokens is None else max_new_tokens,
                             self.steps_per_call)

    def _verify(self, hist, hist_lens, last_tok, cur_lens, active, slot: int):
        """One batched verify with the block's KV written at ``slot``:
        returns (g (lanes, k+1) greedy tokens, emit (lanes,) tokens taken,
        0 for idle lanes), and appends g to each lane's history in place."""
        k = self.spec_k
        kp1 = k + 1
        dev = self.device
        proposer = self._proposer or partial(ngram_propose, k=k, m=self.spec_m)
        drafts = proposer(hist, hist_lens).to(torch.int32)
        block = torch.cat([last_tok[:, None], drafts], dim=1)
        js = torch.arange(kp1, device=dev)
        # the committed validity for each of the k+1 queries, with the
        # window's causal triangle at its slots (still dead in valid)
        bias = torch.where(self.valid, 0.0, NEG)[:, None, None, :].expand(
            -1, 1, kp1, -1).clone()
        bias[..., slot:slot + kp1] = torch.where(js[None] <= js[:, None], 0.0, NEG)
        logits, _ = llama_apply(self.params, self.cfg, block, cur_lens[:, None] + js[None], bias,
                                cache=self.cache, write_pos=slot, lora=self.lora,
                                policy=self.policy, verify=True)
        g = torch.argmax(logits.float(), dim=-1).to(torch.int32)            # (lanes, k+1)
        accepted = torch.cumprod((drafts == g[:, :k]).int(), dim=1).sum(dim=1)
        emit = accepted + 1
        eos_in = (g == self.dp.eos_token_id) & (js[None] < emit[:, None])
        emit = torch.where(eos_in.any(dim=1), torch.argmax(eos_in.int(), dim=1) + 1, emit)
        emit = torch.where(active, emit, 0)
        # ragged per-lane history append at each lane's length, start clamped
        start = hist_lens.long().clamp(max=hist.shape[1] - kp1)
        hist.scatter_(1, start[:, None] + js[None], g)
        return g, emit

    def _chunk(self, window_slot, prompt_lens) -> List[int]:
        """``steps_per_call`` verifies from the host state, verify i's block
        at slot window_slot(i), then one read-back of every result and the
        host's token append. Returns the sids finished."""
        active_np = np.asarray([s is not None for s in self.lane_session], np.bool_)

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        active, hist_lens = dev(active_np), dev(self.hist_lens)
        last_tok, cur_lens = dev(self.last_tok), dev(self.cur_lens)
        toks, emits = [], []
        with torch.no_grad():
            for i in range(self.steps_per_call):
                slot = window_slot(i)
                g, emit = self._verify(self.hist, hist_lens, last_tok, cur_lens, active, slot)
                self._after_verify(slot, emit, cur_lens, prompt_lens)
                emit = emit.to(torch.int32)
                hist_lens = hist_lens + emit
                bonus = g.gather(1, (emit.long() - 1).clamp(min=0)[:, None])[:, 0]
                last_tok = torch.where(active, bonus, last_tok)
                cur_lens = cur_lens + emit
                toks.append(g)
                emits.append(emit)
            # the chunk's one read-back
            host = torch.cat([hist_lens, last_tok, cur_lens, torch.stack(emits).reshape(-1),
                              torch.stack(toks).reshape(-1)]).cpu().numpy()
        n, lanes = self.steps_per_call, self.lanes
        self.hist_lens, self.last_tok, self.cur_lens = (host[j * lanes:(j + 1) * lanes].copy()
                                                        for j in range(3))
        emits_np = host[3 * lanes:(3 + n) * lanes].reshape(n, lanes)
        toks_np = host[(3 + n) * lanes:].reshape(n, lanes, self.spec_k + 1)
        return self._drain(toks_np, emits_np, active_np, [])

    def _after_verify(self, slot: int, emit, cur_lens, prompt_lens) -> None:
        """The ring's window: slot j holds block[j]'s KV, live iff j < emit
        (it conditioned only on accepted drafts)."""
        js = torch.arange(self.spec_k + 1, device=self.device)
        self.valid[:, slot:slot + self.spec_k + 1] = js[None] < emit[:, None]

    def step(self) -> List[int]:
        """Admit, then one chunk of ``steps_per_call`` verifies for every
        lane. Returns the sids finished by it."""
        self._admit()
        if self.active_lanes == 0:
            return []
        kp1 = self.spec_k + 1
        ring_base = self.ring_pos % self.ring_len
        self.ring_pos += self.steps_per_call * kp1
        return self._chunk(lambda i: self.prompt_len + (ring_base + i * kp1) % self.ring_len,
                           None)

    def _drain(self, toks, emits, active, newly_finished: List[int]) -> List[int]:
        """Per-lane token append and eos/budget trim on the host. A lane
        verifies on to the chunk's end after its last token; what it
        produced past eos or its budget is never appended."""
        self.verifies += int(self.steps_per_call * active.sum())
        for lane, sess in enumerate(self.lane_session):
            if sess is None:
                continue
            for i in range(self.steps_per_call):
                stop = False
                for tok in toks[i, lane, :emits[i, lane]].tolist():
                    sess.tokens.append(int(tok))
                    self.steps[lane] += 1
                    if tok == self.dp.eos_token_id or self.steps[lane] >= sess.max_new_tokens:
                        stop = True
                        break
                if stop:
                    self._finish(lane, sess)
                    newly_finished.append(sess.sid)
                    break
        return newly_finished

    def _admit(self) -> None:
        # RingBatcher._admit, then each new lane's drafter history: its
        # prompt and the prefill's first token
        before = [s is not None for s in self.lane_session]
        super()._admit()
        for lane, (was, sess) in enumerate(zip(before, self.lane_session)):
            if was or sess is None:
                continue
            t = len(sess.prompt_ids)
            row = np.full((self.hist.shape[1],), -1, np.int32)
            row[:t] = sess.prompt_ids
            row[t:t + 1] = sess.tokens[:1]
            self.hist[lane] = torch.from_numpy(row).to(self.device)
            self.hist_lens[lane] = t + 1


class SpecCompactBatcher(SpecRingBatcher):
    """Batched speculation without the ring: each verify writes its block at
    the fixed scratch window [WB, WB + k + 1) at the cache's end, then each
    lane's accepted rows are copied to its frontier fr = P + generated
    count:

        cache    [0, P) prompt | [P, WB) generated | [WB, WB + k + 1) window
        verify   block KV at WB, attending committed rows + the window's triangle
        relocate rows j < emit: WB + j -> fr + j (bytes copied as they are,
                 int8 rows and scales too; positions live in the RoPE'd K)

    A lane's live rows are then [0, len) and [P, fr): one interval, so the
    int8 cache works too (``kv_int8``, the unrolled serving params only)."""

    _ring_wraps = False
    _takes_int8 = True

    def _check_capacity(self, cache_len: int, prompt_len: int, max_new: int,
                        steps_per_call: int) -> None:
        """A session's generated rows (<= max_new - 1) must fit before the
        window; rows a lane produces past its budget are not relocated."""
        gen_cap = cache_len - prompt_len - (self.spec_k + 1)
        if max_new > gen_cap:
            raise ValueError(f"max_new_tokens {max_new} exceeds the generation region "
                             f"{gen_cap} (= cache {cache_len} - prompt {prompt_len} - "
                             f"window {self.spec_k + 1})")

    def _after_verify(self, slot: int, emit, cur_lens, prompt_lens) -> None:
        """Relocate the window's accepted rows to each lane's frontier. JAX
        scatters with mode="drop" (dest = S for a row not kept); an
        out-of-range index is an error here (a device-side assert on the
        card), so a row not kept (j >= emit, or past WB) is written back
        onto its own window slot instead: the same bytes, no index out of
        range, and no host read to select the rows."""
        kp1 = self.spec_k + 1
        wb = slot
        js = torch.arange(kp1, device=self.device)
        dest = self.prompt_len + (cur_lens - prompt_lens)[:, None].long() + js[None]
        ok = (js[None] < emit[:, None]) & (dest < wb)
        dest = torch.where(ok, dest, wb + js[None])
        bidx = torch.arange(self.lanes, device=self.device)[:, None]
        bufs = [self.cache.k, self.cache.v]
        if self.cache.quantized:
            bufs += [self.cache.k_scale, self.cache.v_scale]
        for buf in bufs:
            buf[:, bidx, dest] = buf[:, :, wb:wb + kp1].clone()
        self.valid[bidx, dest] = ok

    def step(self) -> List[int]:
        """Admit, then ``steps_per_call`` verify + relocate iterations."""
        self._admit()
        if self.active_lanes == 0:
            return []
        wb = self.cache_len - (self.spec_k + 1)
        return self._chunk(lambda i: wb, torch.from_numpy(self.prompt_lens).to(self.device))
