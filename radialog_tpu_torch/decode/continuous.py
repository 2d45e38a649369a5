"""Continuous batching: many interactive sessions share one decode loop
(port of radialog_tpu/decode/continuous.py ``ContinuousBatcher`` and
``RingBatcher``).

``ContinuousBatcher`` serves the stacked float params (the float path) over
one (L, lanes, S, H, D) bf16 cache. A lane's slot is the token's position:
admission is a batch-1 prefill without a cache, its prompt bucketed to a
multiple of 32 and installed into the lane's rows [0, T) (the bucket's tail
is never unmasked); one greedy step for all lanes writes each lane's K/V
at its own length (a (B,) ``write_pos``: one indexed write) under
``decode_bias(cur_lens + 1)``. Idle and finished lanes compute garbage the
host ignores; their writes land at their frozen length, which stays masked
until the lane's next admission overwrites it.

``RingBatcher`` serves either weight layout. Sessions are admitted and
evicted at chunk granularity into fixed lanes of one pre-allocated cache.
Slots [0, P) of a lane are its PROMPT region, filled at admission by a
batch-1 prefill in 32-token buckets; slots [P, S) are a GENERATION RING
shared by position: every lane writes step t's K/V at the same slot
P + (t mod ring_len) of its own rows. Slots no longer encode token
positions: RoPE is applied from the lane's true position, and validity is
carried explicitly. With the bf16 cache it is a (lanes, S) bitmask that
becomes the attention bias; with the int8 cache (the unrolled serving
params only) the flash-decode kernel (ops/flash_decode.py) takes it as
per-lane closed slot intervals: a lane's generated slots are the last
``writes`` ring positions ending at the current one, one contiguous ring
window, so at most two slot intervals. Ring reuse is safe because a session
writes one slot per step and its span is checked against the ring at
admission.

PyTorch idiom: the cache and the bitmask are mutated in place (the JAX
package donates them to each jitted call), and each call reads back once:
a ``ContinuousBatcher`` step its tokens, a ring chunk (a Python loop of
``steps_per_call`` decode steps; the JAX package scans them inside one jit
call) its last tokens, positions and sampled tokens.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..models.llama import (LlamaConfig, decode_bias, find_img_start, init_cache,
                            llama_apply, prefill_bias)
from ..ops.layers import DTypePolicy, FP32
from .engine import DecodeParams
from .kvcache import install_prefill

NEG = -1e30


def _bucket32(n: int) -> int:
    return max(32, ((n + 31) // 32) * 32)


def ring_intervals(writes: torch.Tensor, e: int, prompt_len: int, ring_len: int):
    """The closed slot intervals (a1, b1, a2, b2), each (lanes,), of lanes
    whose generated slots are the last ``writes`` ring positions ending at
    ring position ``e``: one contiguous ring window, so at most two slot
    intervals; an empty interval is marked b = -1."""
    start = e - (writes - 1)
    a1 = prompt_len + torch.clamp(start, min=0)
    b1 = torch.where(writes > 0, prompt_len + e, -1)
    wrap = start < 0
    a2 = torch.where(wrap, prompt_len + ring_len + start, 0)
    b2 = torch.where(wrap, prompt_len + ring_len - 1, -1)
    return a1, b1, a2, b2


@dataclasses.dataclass
class Session:
    sid: int
    prompt_ids: List[int]
    img_embs: Optional[torch.Tensor]
    max_new_tokens: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Admit and evict interactive sessions into a shared greedy decode
    step over the stacked float params, one step at a time. Not
    thread-safe: one thread owns it."""

    # the tensor-parallel group of the forward (parallel/tp_ring.py sets it)
    tp_group = None

    def __init__(self, params: Dict, cfg: LlamaConfig, lanes: int = 4,
                 cache_len: int = 512, dp: DecodeParams = DecodeParams(),
                 lora: Optional[Dict] = None, policy: DTypePolicy = FP32, device="cuda"):
        if isinstance(params["layers"], (list, tuple)):
            raise ValueError(
                "ContinuousBatcher requires the stacked param layout with a bf16 cache; "
                "the unrolled serving layout uses RingBatcher (shared-slot decoding)")
        self.params, self.cfg, self.lora, self.policy = params, cfg, lora, policy
        self.lanes, self.cache_len, self.dp = lanes, cache_len, dp
        self.device = torch.device(device)
        self.cache = init_cache(cfg, lanes, cache_len, device=self.device, quantized=False)
        self.cur_lens = np.zeros(lanes, np.int32)   # KV rows written per lane
        self.last_tok = np.zeros(lanes, np.int32)   # the token whose KV is pending
        self.steps = np.zeros(lanes, np.int32)      # tokens generated so far
        self.lane_session: List[Optional[Session]] = [None] * lanes
        self.queue: Deque[Session] = deque()
        self.finished: Dict[int, Session] = {}
        self._ids = itertools.count()

    # ------------------------------------------------------------- interface
    def submit(self, prompt_ids: List[int], img_embs: Optional[torch.Tensor] = None,
               max_new_tokens: Optional[int] = None) -> int:
        """Queue a request; returns its session id."""
        sid = next(self._ids)
        self.queue.append(Session(sid, list(prompt_ids), img_embs,
                                  max_new_tokens or self.dp.max_new_tokens))
        return sid

    @property
    def active_lanes(self) -> int:
        return sum(s is not None for s in self.lane_session)

    def run(self, max_steps: int = 10_000) -> Dict[int, Session]:
        """Drive until queue and lanes drain. Returns finished sessions."""
        for _ in range(max_steps):
            if not self.queue and self.active_lanes == 0:
                break
            self.step()
        return self.finished

    def step(self) -> List[int]:
        """Admit queued requests into free lanes, run one decode step for
        every lane, evict finished sessions. Returns the sids finished by
        this step."""
        self._admit()
        newly_finished: List[int] = []
        if self.active_lanes == 0:
            return newly_finished
        with torch.no_grad():
            cur = torch.from_numpy(self.cur_lens).to(self.device)
            last = torch.from_numpy(self.last_tok).to(self.device)
            logits, _ = llama_apply(self.params, self.cfg, last[:, None], cur[:, None],
                                    decode_bias(cur + 1, self.cache_len), cache=self.cache,
                                    write_pos=cur, lora=self.lora, policy=self.policy)
            nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()   # the step's read-back
        for lane, sess in enumerate(self.lane_session):
            if sess is None:
                continue
            # the step wrote last_tok's KV at cur_len and produced the next token
            self.cur_lens[lane] += 1
            tok = int(nxt[lane])
            sess.tokens.append(tok)
            self.steps[lane] += 1
            self.last_tok[lane] = tok
            if tok == self.dp.eos_token_id or self.steps[lane] >= sess.max_new_tokens:
                self._finish(lane, sess)
                newly_finished.append(sess.sid)
        return newly_finished

    # -------------------------------------------------------------- internals
    def _finish(self, lane: int, sess: Session) -> None:
        sess.done = True
        self.finished[sess.sid] = sess
        self.lane_session[lane] = None      # evict: the lane is free next step

    @torch.no_grad()
    def _prefill_lane(self, tokens, length: int, lane: int, img_embs):
        """Batch-1 prefill of a bucketed prompt (1, t) without a cache,
        installed into ``lane`` of the cache; returns the first token (0-d,
        on the device)."""
        t = tokens.shape[1]
        dev = tokens.device
        lens = torch.full((1,), length, dtype=torch.int32, device=dev)
        img_start = (find_img_start(tokens, self.cfg.img_token_id)
                     if img_embs is not None else None)
        logits, fresh = llama_apply(
            self.params, self.cfg, tokens, torch.arange(t, device=dev)[None],
            prefill_bias(lens, t), cache=None, img_embs=img_embs, img_start=img_start,
            lora=self.lora, policy=self.policy, lengths=lens, last_pos=lens - 1,
            tp_group=self.tp_group)
        install_prefill(self.cache, fresh, lane=lane)
        return torch.argmax(logits[0, 0], dim=-1)

    def _admit(self) -> None:
        while self.queue and self.active_lanes < self.lanes:
            sess = self.queue.popleft()
            lane = self.lane_session.index(None)
            t = len(sess.prompt_ids)
            tpad = _bucket32(t)
            # guard on the bucketed prompt: the prefill writes tpad rows
            if tpad > self.cache_len or t + sess.max_new_tokens > self.cache_len:
                raise ValueError(
                    f"request needs max(bucketed prompt {tpad}, {t}+{sess.max_new_tokens}) "
                    f"slots > cache_len {self.cache_len}")
            padded = sess.prompt_ids + [self.cfg.pad_token_id] * (tpad - t)
            tokens = torch.tensor([padded], dtype=torch.int32, device=self.device)
            first = int(self._prefill_lane(tokens, t, lane, sess.img_embs))
            self.lane_session[lane] = sess
            self.cur_lens[lane] = t
            self.steps[lane] = 1
            self.last_tok[lane] = first
            sess.tokens.append(first)
            # the prefill's token counts as step 1: a one-token budget ends here
            if first == self.dp.eos_token_id or self.steps[lane] >= sess.max_new_tokens:
                self._finish(lane, sess)


class RingBatcher:
    """Admit and evict interactive sessions into a shared greedy decode
    step over the unrolled serving params or the stacked float params, with
    the bf16 ring cache or (``kv_int8``, unrolled params only) the int8 one.
    ``steps_per_call`` decode steps run between two
    admission rounds; a lane whose session finishes mid-chunk goes on
    decoding until the chunk ends (its writes land in its own rows only, its
    tokens are trimmed). Not thread-safe: one thread owns it."""

    # the generation region rotates (slots reused modulo ring_len); a
    # subclass with linear per-lane frontiers turns the ring-span guards off
    _ring_wraps = True
    tp_group = None

    def __init__(self, params: Dict, cfg: LlamaConfig, lanes: int = 4,
                 cache_len: int = 512, prompt_len: int = 256,
                 dp: DecodeParams = DecodeParams(), lora: Optional[Dict] = None,
                 policy: DTypePolicy = FP32, steps_per_call: int = 1,
                 kv_int8: bool = False, device="cuda"):
        ring_len = cache_len - prompt_len
        k = steps_per_call
        # a session occupies ceil((max_new-1)/k) chunks = that many * k ring
        # advances; the ring must not wrap onto its own live slots
        life = -(-max(dp.max_new_tokens - 1, 1) // k) * k
        if type(self)._ring_wraps and life >= ring_len:
            raise ValueError(
                f"generation ring ({cache_len}-{prompt_len}={ring_len} slots) must exceed "
                f"a session's ring span {life} (max_new_tokens={dp.max_new_tokens} rounded "
                f"up to steps_per_call={k} chunks)")
        if kv_int8 and not isinstance(params["layers"], (list, tuple)):
            raise ValueError("kv_int8 requires the unrolled serving params "
                             "(quantize_llama_host layout)")
        self.params, self.cfg, self.lora, self.policy = params, cfg, lora, policy
        self.lanes, self.cache_len, self.dp = lanes, cache_len, dp
        self.prompt_len, self.ring_len = prompt_len, ring_len
        self.steps_per_call = k
        self.kv_int8 = kv_int8
        self.device = torch.device(device)
        self.cache = self._make_cache()
        self.valid = torch.zeros((lanes, cache_len), dtype=torch.bool, device=self.device)
        self.ring_pos = 0                           # host ring counter
        self.cur_lens = np.zeros(lanes, np.int32)   # true token positions
        self.last_tok = np.zeros(lanes, np.int32)
        self.steps = np.zeros(lanes, np.int32)
        # interval mask state: per-lane admitted prompt length and count of
        # ring writes since admission
        self.prompt_lens = np.zeros(lanes, np.int32)
        self.ring_writes = np.zeros(lanes, np.int32)
        self.lane_session: List[Optional[Session]] = [None] * lanes
        self.queue: Deque[Session] = deque()
        self.finished: Dict[int, Session] = {}
        self._ids = itertools.count()
        self._build_fns()

    # Hooks for the tensor-parallel and speculative variants, which reuse
    # the host admit/evict loop and swap the device programs and the cache.
    def _make_cache(self):
        return init_cache(self.cfg, self.lanes, self.cache_len, device=self.device,
                          quantized=self.kv_int8)

    def _build_fns(self) -> None:
        cfg, prompt_len, ring_len = self.cfg, self.prompt_len, self.ring_len

        @torch.no_grad()
        def step_fn(last_tok, cur_lens, active, ring_base: int, prompt_lens, writes):
            """``steps_per_call`` decode steps; returns (last_tok, cur_lens,
            tokens (k, lanes)), all on the device."""
            cache, valid = self.cache, self.valid
            grow = active.to(torch.int32)
            toks = []
            for i in range(self.steps_per_call):
                e = (ring_base + i) % ring_len
                slot = prompt_len + e
                # mark the shared ring slot for active lanes before the mask
                # is built: the current token attends itself
                valid[:, slot] = active
                pos = cur_lens[:, None]
                if self.kv_int8:
                    writes = writes + grow
                    logits, _ = llama_apply(
                        self.params, cfg, last_tok[:, None], pos, None, cache=cache,
                        write_pos=slot, lora=self.lora, policy=self.policy,
                        lengths=prompt_lens,
                        slot_info=ring_intervals(writes, e, prompt_len, ring_len),
                        tp_group=self.tp_group)
                else:
                    bias = torch.where(valid, 0.0, NEG)[:, None, None, :]
                    logits, _ = llama_apply(
                        self.params, cfg, last_tok[:, None], pos, bias, cache=cache,
                        write_pos=slot, lora=self.lora, policy=self.policy,
                        tp_group=self.tp_group)
                nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
                last_tok = torch.where(active, nxt, last_tok)
                cur_lens = cur_lens + grow
                toks.append(nxt)
            return last_tok, cur_lens, torch.stack(toks)

        @torch.no_grad()
        def prefill_fn(tokens, length: int, lane: int, img_embs):
            """``_prefill_lane``, then the lane's validity row reset: prompt
            slots [0, length) live, the rest (a former session's rows, the
            ring) dead. Returns the first token (0-d, on the device)."""
            first = self._prefill_lane(tokens, length, lane, img_embs)
            self.valid[lane] = torch.arange(self.cache_len, device=tokens.device) < length
            return first

        self._step_fn = step_fn
        self._prefill_fn = prefill_fn

    # ------------------------------------------------------------- interface
    submit = ContinuousBatcher.submit
    active_lanes = ContinuousBatcher.active_lanes
    run = ContinuousBatcher.run
    _finish = ContinuousBatcher._finish
    _prefill_lane = ContinuousBatcher._prefill_lane

    def step(self) -> List[int]:
        """Admit queued requests into free lanes, run one chunk of
        ``steps_per_call`` decode steps for every lane, evict finished
        sessions. Returns the sids finished by this chunk."""
        self._admit()
        newly_finished: List[int] = []
        if self.active_lanes == 0:
            return newly_finished
        ring_base = self.ring_pos % self.ring_len
        self.ring_pos += self.steps_per_call
        active = np.asarray([s is not None for s in self.lane_session], np.bool_)

        def dev(x):
            return torch.from_numpy(x).to(self.device)
        last_tok, cur_lens, toks = self._step_fn(
            dev(self.last_tok), dev(self.cur_lens), dev(active), ring_base,
            dev(self.prompt_lens), dev(self.ring_writes))
        self.ring_writes[active] += self.steps_per_call
        # the chunk's one read-back: last tokens, positions, sampled tokens
        host = torch.cat([last_tok[None], cur_lens[None], toks]).cpu().numpy()
        self.last_tok, self.cur_lens, toks = host[0].copy(), host[1].copy(), host[2:]
        for lane, sess in enumerate(self.lane_session):
            if sess is None:
                continue
            for i in range(self.steps_per_call):
                tok = int(toks[i, lane])
                sess.tokens.append(tok)
                self.steps[lane] += 1
                if tok == self.dp.eos_token_id or self.steps[lane] >= sess.max_new_tokens:
                    # what the chunk produced past this point is trimmed
                    self._finish(lane, sess)
                    newly_finished.append(sess.sid)
                    break
        return newly_finished

    # -------------------------------------------------------------- internals
    def validate_request(self, n_prompt_tokens: int,
                         max_new_tokens: Optional[int] = None) -> None:
        """Raise ValueError if a request cannot be admitted (callers may
        check before ``submit``: the server rejects per request instead of
        letting ``_admit`` raise inside a shared step loop)."""
        tpad = _bucket32(n_prompt_tokens)
        if tpad > self.prompt_len:
            raise ValueError(f"prompt needs {tpad} slots > prompt region {self.prompt_len}")
        max_new = self.dp.max_new_tokens if max_new_tokens is None else max_new_tokens
        # a session occupies whole chunks of ring writes (a lane decodes to
        # the chunk boundary after its last real token), so the bound is the
        # chunk-rounded span
        k = self.steps_per_call
        life = -(-max(max_new - 1, 1) // k) * k
        if type(self)._ring_wraps and life >= self.ring_len:
            raise ValueError(
                f"max_new_tokens {max_new} needs {life} ring writes (rounded up to "
                f"steps_per_call={k} chunks) >= ring {self.ring_len}")

    def _admit(self) -> None:
        while self.queue and self.active_lanes < self.lanes:
            sess = self.queue.popleft()
            lane = self.lane_session.index(None)
            t = len(sess.prompt_ids)
            self.validate_request(t, sess.max_new_tokens)
            padded = sess.prompt_ids + [self.cfg.pad_token_id] * (_bucket32(t) - t)
            tokens = torch.tensor([padded], dtype=torch.int32, device=self.device)
            first = int(self._prefill_fn(tokens, t, lane, sess.img_embs))
            self.lane_session[lane] = sess
            self.cur_lens[lane] = t
            self.steps[lane] = 1
            self.last_tok[lane] = first
            self.prompt_lens[lane] = t
            self.ring_writes[lane] = 0
            sess.tokens.append(first)
            # the prefill's token counts as step 1: a one-token budget ends here
            if first == self.dp.eos_token_id or self.steps[lane] >= sess.max_new_tokens:
                self._finish(lane, sess)
