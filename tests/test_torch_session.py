"""The interactive session of the PyTorch port (decode/session.py
``InteractiveSession``, utils/streaming.py, ``generate_two_phase``) against
the JAX package on the CPU, TINY_LLAMA, W8A8 serving weights (the
incremental prefill through ``verify``) and the stacked f32 weights, FP32
policy, the same seeded weights through the bridge:

  * three turns (an image prompt, then two text turns; ``generate``,
    ``generate_spec``, ``generate``): each reply's tokens, ``cur_len``,
    ``remaining``, the pending tail and the token history equal JAX's;
  * the session's cache is bf16 on W8A8 weights (the port's ``init_cache``
    defaults to int8); ``warmup`` leaves a reset session;
  * ``generate_two_phase`` equals ``generate``; ``stream_chunks`` gives a
    single ``generate``'s tokens; ``Iteratorize`` yields a producer's items.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.decode.engine import DecodeParams as JDecodeParams
from radialog_tpu.decode.session import InteractiveSession as JSession
from radialog_tpu_torch import bridge
from radialog_tpu_torch.decode import engine as te
from radialog_tpu_torch.decode.session import InteractiveSession
from radialog_tpu_torch.utils.streaming import Iteratorize, stream_chunks

from test_torch_llama import CFG_J, CFG_T, models

CACHE = 128
NEW = 6
# the turns of generator seed 5: at seeds 4, 9, 10 and 12 of 4-13 a layer-0
# activation of the first turn sits on an int8 rounding edge that the jitted
# JAX session prefill rounds apart from the port (and from JAX's own eager
# prefill), ROADMAP.md queue 3 "Observed in the JAX reference"
TURN_SEED = 5
TOL = {"unrolled": 1e-5, "stacked": 2e-4}     # measured 5e-7; f32 over the bf16 cache


@pytest.fixture(scope="module")
def weights():
    return models(0)


def _turns(seed=TURN_SEED):
    rng = np.random.default_rng(seed)
    first = [1] + rng.integers(3, 240, 5).tolist() + [CFG_T.img_token_id] * 4 \
        + rng.integers(3, 240, 8).tolist()
    second = rng.integers(3, 240, 7).tolist()
    third = (first[6:10] + second)[:9]       # quotes the history: drafts accepted
    emb = rng.normal(size=(1, CFG_T.num_img_tokens, CFG_T.qformer_dim)).astype(np.float32)
    return [first, second, third], emb


def _state(s):
    return s.cur_len, s.remaining, list(s._pending_tail), list(s.token_ids)


@pytest.mark.parametrize("layout", ["unrolled", "stacked"])
def test_three_turns_match_jax(weights, layout):
    qp, lora, tp, tlora, params = weights
    if layout == "stacked":
        qp, tp = params, bridge.llama_stacked(jax.tree_util.tree_map(np.asarray, params), "cpu")
    turns, emb = _turns()
    js = JSession(qp, CFG_J, lora=lora, cache_len=CACHE)
    ts = InteractiveSession(tp, CFG_T, lora=tlora, cache_len=CACHE, device="cpu")
    assert not ts.cache.quantized and ts.cache.k.dtype == torch.bfloat16
    jdp = JDecodeParams(max_new_tokens=NEW, eos_token_id=-1)
    tdp = te.DecodeParams(max_new_tokens=NEW, eos_token_id=-1)
    for i, ids in enumerate(turns):
        js.append_tokens(ids, img_embs=jnp.asarray(emb) if i == 0 else None)
        ts.append_tokens(ids, img_embs=torch.from_numpy(emb) if i == 0 else None)
        np.testing.assert_allclose(ts._last_logits.numpy(), np.asarray(js._last_logits),
                                   rtol=0, atol=TOL[layout])
        if i == 1:
            want, got = js.generate_spec(jdp, k=3), ts.generate_spec(tdp, k=3)
        else:
            want, got = js.generate(jdp), ts.generate(tdp)
        assert got == want
        assert _state(ts) == _state(js)
    # each reply's last token waits for the next append
    assert ts._pending_tail and ts.cur_len == sum(map(len, turns)) + 3 * (NEW - 1) + 2


def test_speculative_turn_equals_the_plain_turn(weights):
    _, _, tp, tlora, _ = weights
    turns, emb = _turns()
    out = []
    for spec in (False, True):
        s = InteractiveSession(tp, CFG_T, lora=tlora, cache_len=CACHE, device="cpu")
        s.append_tokens(turns[0], img_embs=torch.from_numpy(emb))
        s.generate(te.DecodeParams(max_new_tokens=NEW, eos_token_id=-1))
        s.append_tokens(turns[2])
        dp = te.DecodeParams(max_new_tokens=12, eos_token_id=-1)
        out.append((s.generate_spec(dp, k=4) if spec else s.generate(dp), _state(s)))
    assert out[0] == out[1]


def test_session_refusals_and_warmup(weights):
    _, _, tp, tlora, _ = weights
    s = InteractiveSession(tp, CFG_T, lora=tlora, cache_len=64, device="cpu")
    dp = te.DecodeParams(max_new_tokens=8, eos_token_id=-1)
    with pytest.raises(RuntimeError, match="append_tokens"):
        s.generate(dp)
    with pytest.raises(ValueError, match="overflow"):
        s.append_tokens([5] * 70)
    s.append_tokens([5, 6, 7])
    with pytest.raises(ValueError, match="k <= 15"):
        s.generate_spec(dp, k=16)
    with pytest.raises(ValueError, match="overflow"):
        s.generate(te.DecodeParams(max_new_tokens=62))
    assert s.warmup(dp, turn_lengths=(16, 20), spec_k=3) >= 0
    assert _state(s) == (0, 64, [], []) and s._last_logits is None
    assert not s.cache.k.any()


def test_two_phase_equals_generate(weights):
    _, _, tp, tlora, _ = weights
    turns, emb = _turns()
    tokens = torch.tensor([turns[0], turns[0][:10] + [0] * 8], dtype=torch.int32)
    lens = torch.tensor([18, 10], dtype=torch.int32)
    dp = te.DecodeParams(max_new_tokens=NEW, eos_token_id=-1)
    a = te.generate(tp, CFG_T, tokens, lens, dp, lora=tlora)
    b = te.generate_two_phase(tp, CFG_T, tokens, lens, dp, lora=tlora)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.lengths, b.lengths)


def test_stream_chunks_equal_one_generate_and_iteratorize(weights):
    _, _, tp, tlora, _ = weights
    turns, emb = _turns()
    dp = te.DecodeParams(max_new_tokens=14, eos_token_id=-1)
    whole = InteractiveSession(tp, CFG_T, lora=tlora, cache_len=CACHE, device="cpu")
    whole.append_tokens(turns[0], img_embs=torch.from_numpy(emb))
    want = whole.generate(dp)
    s = InteractiveSession(tp, CFG_T, lora=tlora, cache_len=CACHE, device="cpu")
    s.append_tokens(turns[0], img_embs=torch.from_numpy(emb))
    chunks = list(stream_chunks(s, dp, chunk_size=4, max_new_tokens=14))
    assert [len(c) for c in chunks] == [4, 4, 4, 2]
    assert sum(chunks, []) == want
    # the last chunk's tail is fed too (as in JAX): the session is armed again
    assert s.cur_len == whole.cur_len + 1 and not s._pending_tail
    assert s._last_logits is not None

    def producer(callback):
        for c in chunks:
            callback(c)
    assert list(Iteratorize(producer, timeout=10)) == chunks


@pytest.mark.parametrize("layout", ["unrolled", "stacked"])
def test_stream_chunk_boundaries_are_bitwise_one_decode(weights, layout):
    """stream_chunks feeds each chunk's last token through one decode step
    (``feed_pending``), the step an uninterrupted decode takes there: the
    cache's rows and the next logits are bitwise one generate's followed by
    its own feed. (JAX's 16-row incremental prefill at the boundary rounds
    apart in bf16 on a card, which parted ask_stream from ask.)"""
    params = weights[2] if layout == "unrolled" else bridge.llama_stacked(
        jax.tree_util.tree_map(np.asarray, weights[4]), "cpu")
    turns, emb = _turns()
    dp = te.DecodeParams(max_new_tokens=14, eos_token_id=-1)
    runs = []
    for chunked in (False, True):
        s = InteractiveSession(params, CFG_T, lora=weights[3], cache_len=CACHE, device="cpu")
        s.append_tokens(turns[0], img_embs=torch.from_numpy(emb))
        if chunked:
            ids = sum(stream_chunks(s, dp, chunk_size=4, max_new_tokens=14), [])
        else:
            ids = s.generate(dp)
            s.feed_pending()
        runs.append((ids, s))
    (want, whole), (got, s) = runs
    assert got == want and s.cur_len == whole.cur_len and not s._pending_tail
    assert torch.equal(s._last_logits, whole._last_logits)
    assert torch.equal(s.cache.k, whole.cache.k) and torch.equal(s.cache.v, whole.cache.v)
