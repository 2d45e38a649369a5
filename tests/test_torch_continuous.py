"""The port's RingBatcher against the JAX package's on the CPU, TINY_LLAMA,
FP32 policy, the same seeded weights through the bridge and the same
prompts, with staggered admission and a generation ring that wraps.

bf16 ring (W8A8 and W4A8 weights): token ids equal. int8 ring: the JAX
batcher is traced with RADIALOG_FLASH_DECODE_FORCE=interpret so that it takes
its flash-decode kernel with the per-lane slot intervals (its bitmask
fallback requantizes p to int8, which is other arithmetic); teacher-forced
logits of a hand-stepped ring schedule are held under a bound at every seed
tried, and the batchers' token ids are equal at the seed named below.

Why seeds are named: both sides round every activation row to int8 (W8A8)
and every K/V row to int8 or bf16; a one-ulp float difference between XLA
and PyTorch can cross a rounding edge and move the logits by a quantization
step, which flips a greedy token where two logits nearly tie. SEED = 0
crosses no such edge in the scenarios below (in the int8 one a K row of one
prompt does, by one code, without changing a token).

The JAX batcher's own int8 step is no stable reference on the CPU: with
kv_int8=True and the interpret-mode kernel inside its scanned step, its
tokens for one scenario differed between runs in one process (6 of 8 runs
of seed 1 at steps_per_call 1 and 4), while its bf16 ring, the JAX
``llama_apply`` jitted on its own and the port give one answer every time.
So the int8 token test drives the JAX ring's host loop by hand over the
jitted ``llama_apply`` (``_jax_int8_ring_by_hand``), with the JAX batcher's
own prefill."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.decode import continuous as jc
from radialog_tpu.decode.engine import DecodeParams as JDecodeParams
from radialog_tpu.models import llama as jl
from radialog_tpu.ops.quant import quantize_llama_host as jquantize
from radialog_tpu_torch import bridge
from radialog_tpu_torch.decode import continuous as tc
from radialog_tpu_torch.decode.engine import DecodeParams
from radialog_tpu_torch.models import llama as tl
from radialog_tpu_torch.ops import flash_decode as tfd

from test_torch_llama import packed_tree

CJ, CT = jl.TINY_LLAMA, tl.TINY_LLAMA
SEED = 0
LANES, CACHE, PROMPT, NEW = 2, 64, 32, 12      # ring of 32 slots
# teacher-forced logits (std ~1) of the int8 ring: see the docstring of
# test_int8_ring_teacher_forced_logits for how the bound was set
BOUND = {"max": 0.25, "mean": 0.025}


def _models(seed, bits=8):
    params = jax.tree_util.tree_map(np.asarray, jl.llama_init(jax.random.PRNGKey(seed), CJ))
    qp = jquantize(params, bits=bits)
    lora = jl.lora_init(jax.random.PRNGKey(seed + 1), CJ)
    rng = np.random.default_rng(seed)
    for t in lora["layers"]:
        lora["layers"][t]["b"] = jnp.asarray(
            rng.normal(size=lora["layers"][t]["b"].shape).astype(np.float32) * 0.1)
    tp = bridge.llama_serving(packed_tree(qp), CT, device="cpu")
    tlora = bridge.lora(jax.tree_util.tree_map(np.asarray, lora), device="cpu")
    return qp, lora, tp, tlora


def _requests(seed, n=7):
    """(prompt ids, image embeddings or None): lengths 3..30, every third
    prompt with an <IMG> run and its embeddings."""
    rng = np.random.default_rng(100 + seed)
    out = []
    for j in range(n):
        ids = [int(x) for x in rng.integers(3, 240, int(rng.integers(3, 31)))]
        emb = None
        if j % 3 == 1:
            ids = ids[:2] + [CJ.img_token_id] * CJ.num_img_tokens + ids[2:20]
            emb = rng.normal(size=(1, CJ.num_img_tokens, CJ.qformer_dim)).astype(np.float32)
        out.append((ids, emb))
    return out


def _drive(rb, requests, conv):
    """Staggered admission: two requests, a chunk, one more, a chunk, the
    rest; then drain. Returns each session's tokens in request order."""
    def submit(r):
        return rb.submit(r[0], img_embs=None if r[1] is None else conv(r[1]))
    sids = [submit(r) for r in requests[:2]]
    rb.step()
    sids.append(submit(requests[2]))
    rb.step()
    sids += [submit(r) for r in requests[3:]]
    done = rb.run()
    assert set(done) == set(sids)
    return [done[s].tokens for s in sids]


def _batchers(seed, bits, kv_int8, steps_per_call=4, new=NEW):
    qp, lora, tp, tlora = _models(seed, bits)
    jrb = jc.RingBatcher(qp, CJ, lanes=LANES, cache_len=CACHE, prompt_len=PROMPT,
                         dp=JDecodeParams(max_new_tokens=new, eos_token_id=-1), lora=lora,
                         steps_per_call=steps_per_call, kv_int8=kv_int8)
    trb = tc.RingBatcher(tp, CT, lanes=LANES, cache_len=CACHE, prompt_len=PROMPT,
                         dp=DecodeParams(max_new_tokens=new, eos_token_id=-1), lora=tlora,
                         steps_per_call=steps_per_call, kv_int8=kv_int8, device="cpu")
    return jrb, trb


@pytest.mark.parametrize("bits", [8, 4])
def test_bf16_ring_matches_jax(bits):
    jrb, trb = _batchers(SEED, bits, kv_int8=False)
    assert not trb.cache.quantized and trb.cache.k.shape == (2, LANES, CACHE, 4, 16)
    assert trb.cache.k.dtype == torch.bfloat16
    reqs = _requests(SEED)
    want = _drive(jrb, reqs, jnp.asarray)
    got = _drive(trb, reqs, torch.from_numpy)
    assert got == want
    assert all(len(t) == NEW for t in got)
    assert trb.ring_pos == jrb.ring_pos and trb.ring_pos > trb.ring_len     # the ring wrapped
    np.testing.assert_array_equal(trb.valid.numpy(), np.asarray(jrb.valid))


def _jax_int8_ring_by_hand(qp, lora, requests, new=NEW):
    """The JAX package's int8 ring at steps_per_call = 1, its host loop
    written out: requests admitted two at a time through the JAX batcher's
    own prefill (batch-1 prefill, install_prefill into the lane), then
    greedy steps of the jitted ``llama_apply`` with the ring slot and the
    per-lane intervals. The JAX batcher's own scanned step is no stable
    reference on the CPU (this file's docstring)."""
    jrb = jc.RingBatcher(qp, CJ, lanes=LANES, cache_len=CACHE, prompt_len=PROMPT,
                         dp=JDecodeParams(max_new_tokens=new, eos_token_id=-1), lora=lora,
                         kv_int8=True)
    cache, valid = jrb.cache, jrb.valid

    @jax.jit
    def jstep(cache, tok, pos, lens, iv, slot):
        logits, cache = jl.llama_apply(qp, CJ, tok[:, None], pos[:, None], None, cache=cache,
                                       write_pos=slot, lora=lora, lengths=lens, slot_info=iv)
        return jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32), cache

    out, ring_pos = [], 0
    for r in range(0, len(requests), LANES):
        batch = requests[r:r + LANES]
        lens, tok = np.zeros(LANES, np.int32), np.zeros(LANES, np.int32)
        for lane, (ids, emb) in enumerate(batch):
            cache, valid, first = jrb._prefill_fn(
                qp, lora, cache, valid, jnp.asarray(ids + [0] * (32 - len(ids)), jnp.int32)[None],
                jnp.asarray(len(ids), jnp.int32), jnp.asarray(lane, jnp.int32),
                None if emb is None else jnp.asarray(emb), t=32)
            lens[lane], tok[lane] = len(ids), int(first)
        toks, cur, writes = [tok.copy()], lens.copy(), np.zeros(LANES, np.int32)
        active = np.arange(LANES) < len(batch)
        for _ in range(new - 1):
            e = ring_pos % (CACHE - PROMPT)
            ring_pos += 1
            writes += active
            nxt, cache = jstep(cache, jnp.asarray(tok), jnp.asarray(cur), jnp.asarray(lens),
                               tuple(jnp.asarray(x) for x in _intervals(writes, e)),
                               jnp.asarray(PROMPT + e))
            tok = np.where(active, np.asarray(nxt), tok)
            cur += active
            toks.append(tok.copy())
        out += [[int(t[lane]) for t in toks] for lane in range(len(batch))]
    return out, ring_pos


def test_int8_ring_tokens_match_jax(monkeypatch):
    monkeypatch.setenv("RADIALOG_FLASH_DECODE_FORCE", "interpret")
    qp, lora, tp, tlora = _models(SEED)
    reqs = _requests(SEED, 8)
    want, ring_pos = _jax_int8_ring_by_hand(qp, lora, reqs)
    trb = tc.RingBatcher(tp, CT, lanes=LANES, cache_len=CACHE, prompt_len=PROMPT,
                         dp=DecodeParams(max_new_tokens=NEW, eos_token_id=-1), lora=tlora,
                         kv_int8=True, device="cpu")
    sids = [trb.submit(ids, None if e is None else torch.from_numpy(e)) for ids, e in reqs]
    done = trb.run()
    assert [done[s].tokens for s in sids] == want
    assert trb.ring_pos == ring_pos and ring_pos > trb.ring_len        # the ring wrapped


def test_int8_ring_chunked_staggered_tokens_match_jax(monkeypatch):
    """The port's int8 batcher at steps_per_call = 4 with staggered
    admission (sessions join mid-stream, lanes are reused in another order,
    finished lanes decode on to the end of their chunk) against the
    hand-driven JAX loop's tokens. A session attends only its own lane's
    rows, so its tokens do not depend on when it was admitted or on which
    ring slots it wrote, up to the order of the softmax sums; SEED crosses
    no rounding edge under either schedule."""
    monkeypatch.setenv("RADIALOG_FLASH_DECODE_FORCE", "interpret")
    qp, lora, tp, tlora = _models(SEED)
    reqs = _requests(SEED, 8)
    want, _ = _jax_int8_ring_by_hand(qp, lora, reqs)
    trb = tc.RingBatcher(tp, CT, lanes=LANES, cache_len=CACHE, prompt_len=PROMPT,
                         dp=DecodeParams(max_new_tokens=NEW, eos_token_id=-1), lora=tlora,
                         steps_per_call=4, kv_int8=True, device="cpu")
    got = _drive(trb, reqs, torch.from_numpy)
    assert got == want
    assert trb.ring_pos > trb.ring_len                                  # the ring wrapped


def _intervals(writes, e):
    """The ring's closed slot intervals for write counts ``writes`` (B,)
    ending at ring position e (numpy, the host's arithmetic)."""
    ring = CACHE - PROMPT
    start = e - (writes - 1)
    a1 = PROMPT + np.maximum(start, 0)
    b1 = np.where(writes > 0, PROMPT + e, -1)
    a2 = np.where(start < 0, PROMPT + ring + start, 0)
    b2 = np.where(start < 0, PROMPT + ring - 1, -1)
    return tuple(x.astype(np.int32) for x in (a1, b1, a2, b2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_ring_teacher_forced_logits(monkeypatch, seed):
    """A ring schedule stepped by hand, the same forced ids fed to both
    sides: lane 0 decodes steps 0-24 and is re-admitted with another prompt
    at step 30; lane 1 has no session until step 20 (no valid slot: the
    attention output is zeros), then decodes steps 20-44 and its window
    wraps at ring position 32, both intervals live. Logits of the active
    lanes are compared at every step.

    Bound: max |err| < 0.25 and mean |err| < 0.025, the bound of
    tests/test_torch_teacher_forced.py, set there from measured int8
    rounding-edge crossings (up to 0.122 and 0.0178) and measured faults.
    Measured here: seeds 0 and 2 agree to 9.5e-7 (mean 5.3e-8), seed 1
    crosses an edge by 0.095 (mean 0.0062). A mask that drops the wrapped
    second interval moves them by 3.5 and 2.4 (mean 0.18 and 0.13) at seeds
    0 and 2."""
    monkeypatch.setenv("RADIALOG_FLASH_DECODE_FORCE", "interpret")
    qp, lora, tp, tlora = _models(seed)
    jrb = jc.RingBatcher(qp, CJ, lanes=LANES, cache_len=CACHE, prompt_len=PROMPT,
                         dp=JDecodeParams(max_new_tokens=26, eos_token_id=-1), lora=lora,
                         kv_int8=True)
    trb = tc.RingBatcher(tp, CT, lanes=LANES, cache_len=CACHE, prompt_len=PROMPT,
                         dp=DecodeParams(max_new_tokens=26, eos_token_id=-1), lora=tlora,
                         kv_int8=True, device="cpu")
    reqs = _requests(seed, 3)
    rng = np.random.default_rng(200 + seed)
    forced = rng.integers(3, 240, (45, LANES)).astype(np.int32)
    jcache, jvalid = jrb.cache, jrb.valid

    @jax.jit
    def jstep(cache, tok, pos, lens, iv, slot):
        return jl.llama_apply(qp, CJ, tok[:, None], pos[:, None], None, cache=cache,
                              write_pos=slot, lora=lora, lengths=lens, slot_info=iv)

    def admit(lane, req):
        nonlocal jcache, jvalid
        ids, emb = req
        padded = ids + [0] * (32 - len(ids))
        jcache, jvalid, _ = jrb._prefill_fn(
            qp, lora, jcache, jvalid, jnp.asarray(padded, jnp.int32)[None],
            jnp.asarray(len(ids), jnp.int32), jnp.asarray(lane, jnp.int32),
            None if emb is None else jnp.asarray(emb), t=32)
        trb._prefill_fn(torch.tensor([padded], dtype=torch.int32), len(ids), lane,
                        None if emb is None else torch.from_numpy(emb))
        lens[lane], cur[lane], writes[lane], active[lane] = len(ids), len(ids), 0, True

    lens, cur = np.zeros(LANES, np.int32), np.zeros(LANES, np.int32)
    writes, active = np.zeros(LANES, np.int32), np.zeros(LANES, bool)
    errs = []
    admit(0, reqs[0])
    for step in range(45):
        if step == 20:
            admit(1, reqs[1])
        if step == 25:
            active[0] = False
        if step == 30:
            admit(0, reqs[2])
        e = step % (CACHE - PROMPT)
        writes += active
        iv = _intervals(writes, e)
        jlog, jcache = jstep(jcache, jnp.asarray(forced[step]), jnp.asarray(cur),
                             jnp.asarray(lens), tuple(jnp.asarray(x) for x in iv),
                             jnp.asarray(PROMPT + e))
        tlog, _ = tl.llama_apply(tp, CT, torch.from_numpy(forced[step])[:, None],
                                 torch.from_numpy(cur)[:, None], None, cache=trb.cache,
                                 write_pos=PROMPT + e, lora=tlora,
                                 lengths=torch.from_numpy(lens),
                                 slot_info=tuple(torch.from_numpy(x) for x in iv))
        assert torch.isfinite(tlog).all()
        errs.append(np.abs(tlog[:, 0].numpy() - np.asarray(jlog[:, 0]))[active])
        cur += active
    assert writes[1] - 1 > 44 % (CACHE - PROMPT)              # lane 1's window wrapped
    err = np.concatenate(errs)
    assert err.max() < BOUND["max"] and err.mean() < BOUND["mean"], (err.max(), err.mean())


def test_interval_mask_equals_the_bitmask(monkeypatch):
    """At every int8 decode step the per-lane intervals handed to
    flash-decode mark the slots that the ring's validity bitmask marks, for
    every lane with a session, through admissions, evictions and a wrap."""
    _, _, tp, tlora = _models(SEED)
    rb = tc.RingBatcher(tp, CT, lanes=LANES, cache_len=CACHE, prompt_len=PROMPT,
                        dp=DecodeParams(max_new_tokens=NEW, eos_token_id=-1), lora=tlora,
                        steps_per_call=4, kv_int8=True, device="cpu")
    seen = {"steps": 0, "wrapped": 0}
    real = tl.flash_decode_int8

    def checked(q, k8, ks, v8, vs, lengths, layer_idx=0, gen_intervals=None, **kw):
        if layer_idx == 0:
            lens, a1, b1, a2, b2 = (x[:, None].long() for x in
                                    tfd.slot_masks(lengths, gen_intervals=gen_intervals))
            pos = torch.arange(CACHE)[None]
            mask = (pos < lens) | ((pos >= a1) & (pos <= b1)) | ((pos >= a2) & (pos <= b2))
            live = torch.tensor([s is not None for s in rb.lane_session])
            assert torch.equal(mask[live], rb.valid[live])
            seen["steps"] += 1
            seen["wrapped"] += int((b2[live] >= 0).any())
        return real(q, k8, ks, v8, vs, lengths, layer_idx=layer_idx,
                    gen_intervals=gen_intervals, **kw)
    monkeypatch.setattr(tl, "flash_decode_int8", checked)
    _drive(rb, _requests(SEED), torch.from_numpy)
    assert seen["steps"] == rb.ring_pos and seen["wrapped"] > 0


@pytest.mark.parametrize("kv_int8", [False, True])
def test_steps_per_call_gives_the_same_tokens(kv_int8):
    _, _, tp, tlora = _models(SEED)
    out = []
    for k in (1, 4):
        rb = tc.RingBatcher(tp, CT, lanes=LANES, cache_len=CACHE, prompt_len=PROMPT,
                            dp=DecodeParams(max_new_tokens=NEW, eos_token_id=-1), lora=tlora,
                            steps_per_call=k, kv_int8=kv_int8, device="cpu")
        sids = [rb.submit(ids, None if e is None else torch.from_numpy(e))
                for ids, e in _requests(SEED, 4)]
        done = rb.run()
        out.append([done[s].tokens for s in sids])
    assert out[0] == out[1] and all(len(t) == NEW for t in out[0])


def test_eos_trims_mid_chunk_and_frees_the_lane():
    _, _, tp, tlora = _models(SEED)
    ids = _requests(SEED, 1)[0][0]
    free = tc.RingBatcher(tp, CT, lanes=1, cache_len=CACHE, prompt_len=PROMPT,
                          dp=DecodeParams(max_new_tokens=NEW, eos_token_id=-1), lora=tlora,
                          steps_per_call=4, device="cpu")
    sid = free.submit(ids)
    toks = free.run()[sid].tokens
    eos = toks[5]                                   # a token mid-chunk becomes EOS
    rb = tc.RingBatcher(tp, CT, lanes=1, cache_len=CACHE, prompt_len=PROMPT,
                        dp=DecodeParams(max_new_tokens=NEW, eos_token_id=eos), lora=tlora,
                        steps_per_call=4, device="cpu")
    a, b = rb.submit(ids), rb.submit(ids)
    done = rb.run()
    cut = toks[:toks.index(eos) + 1]
    assert done[a].tokens == cut and done[b].tokens == cut and rb.active_lanes == 0


def test_validate_request_bounds_and_one_token_budget():
    _, _, tp, _ = _models(SEED)
    dp = DecodeParams(max_new_tokens=8, eos_token_id=-1)
    rb = tc.RingBatcher(tp, CT, lanes=1, cache_len=96, prompt_len=32, dp=dp, steps_per_call=8,
                        device="cpu")                      # ring_len = 64
    rb.validate_request(4, max_new_tokens=57)              # 56 writes < 64
    with pytest.raises(ValueError, match="ring"):
        rb.validate_request(4, max_new_tokens=60)          # ceil(59/8)*8 = 64
    with pytest.raises(ValueError, match="prompt region"):
        rb.validate_request(40)                            # buckets to 64 > 32
    rb.submit(list(range(3, 43)))
    with pytest.raises(ValueError, match="prompt region"):
        rb.step()
    with pytest.raises(ValueError, match="ring"):
        tc.RingBatcher(tp, CT, lanes=1, cache_len=64, prompt_len=32,
                       dp=dataclasses.replace(dp, max_new_tokens=40), device="cpu")
    rb = tc.RingBatcher(tp, CT, lanes=2, cache_len=96, prompt_len=32, dp=dp, device="cpu")
    one = rb.submit(list(range(3, 10)), max_new_tokens=1)
    assert len(rb.run()[one].tokens) == 1
    three = rb.submit(list(range(3, 12)), max_new_tokens=3)
    assert len(rb.run()[three].tokens) == 3
    assert [tc._bucket32(n) for n in (1, 32, 33, 250)] == [jc._bucket32(n)
                                                           for n in (1, 32, 33, 250)]


def test_kv_int8_rejects_stacked_params():
    stacked = tl.llama_init(torch.Generator().manual_seed(0), CT, device="cpu")
    with pytest.raises(ValueError, match="unrolled"):
        tc.RingBatcher(stacked, CT, lanes=1, cache_len=96, prompt_len=32,
                       dp=DecodeParams(max_new_tokens=6), kv_int8=True, device="cpu")


def test_bf16_cache_helpers_match_jax():
    """decode_bias, init_cache(quantized=False) and the bf16 install_prefill."""
    from radialog_tpu.decode.kvcache import install_prefill as jinstall
    from radialog_tpu_torch.decode.kvcache import install_prefill
    lens = np.asarray([0, 3, 8], np.int32)
    np.testing.assert_array_equal(tl.decode_bias(torch.from_numpy(lens), 8).numpy() < -1e8,
                                  np.asarray(jl.decode_bias(jnp.asarray(lens), 8)) < -1e8)
    assert tl.decode_bias(torch.from_numpy(lens), 8).shape == (3, 1, 1, 8)
    rng = np.random.default_rng(0)
    fk, fv = (rng.normal(size=(2, 1, 5, 4, 16)).astype(np.float32) for _ in range(2))
    jcache = jinstall(jl.init_cache(CJ, 3, 8), jl.KVCache(jnp.asarray(fk), jnp.asarray(fv)),
                      lane=1)
    tcache = install_prefill(tl.init_cache(CT, 3, 8, device="cpu", quantized=False),
                             tl.PrefixKV(torch.from_numpy(fk), torch.from_numpy(fv)), lane=1)
    for name in ("k", "v"):
        np.testing.assert_array_equal(getattr(tcache, name).float().numpy(),
                                      np.asarray(getattr(jcache, name)).astype(np.float32))
