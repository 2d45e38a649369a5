"""``ContinuousBatcher`` of the PyTorch port (decode/continuous.py): staggered
sessions over the stacked float params and one bf16 cache, at TINY_LLAMA,
FP32 policy, on the CPU, mirroring the JAX package's tests/test_continuous.py
(sessions equal to their serial ``generate``, eviction, step-granular
admission, the unrolled-params refusal, the overflow guard, the one-token
budget), and the same sessions token-equal to the JAX ``ContinuousBatcher``
on the same weights through the bridge.

A session's numerics do not depend on its lane or its neighbours (its
positions, bias and cache rows are its own), so its greedy tokens equal a
solo ``generate`` of its prompt: asserted exactly, as in the JAX tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.decode.continuous import ContinuousBatcher as JBatcher
from radialog_tpu.decode.engine import DecodeParams as JDecodeParams
from radialog_tpu.models import llama as jl
from radialog_tpu_torch import bridge
from radialog_tpu_torch.decode.continuous import ContinuousBatcher, RingBatcher
from radialog_tpu_torch.decode.engine import DecodeParams, generate
from radialog_tpu_torch.models import llama as tl
from radialog_tpu_torch.ops.quant import quantize_llama_host

CFG = tl.TINY_LLAMA
JPARAMS = jl.llama_init(jax.random.PRNGKey(0), jl.TINY_LLAMA)
PARAMS = bridge.llama_stacked(jax.tree_util.tree_map(np.array, JPARAMS), "cpu")


def _prompt(n, seed):
    return [int(x) for x in np.random.default_rng(seed).integers(3, 200, n)]


def _serial(prompt_ids, max_new):
    out = generate(PARAMS, CFG, torch.tensor([prompt_ids], dtype=torch.int32),
                   torch.tensor([len(prompt_ids)]),
                   DecodeParams(max_new_tokens=max_new, eos_token_id=1), cache_len=128,
                   kv_int8=False)
    return out.tokens[0, :int(out.lengths[0])].tolist()


def _batcher(lanes=2, cache_len=128, max_new=8, eos=1):
    return ContinuousBatcher(PARAMS, CFG, lanes=lanes, cache_len=cache_len,
                             dp=DecodeParams(max_new_tokens=max_new, eos_token_id=eos),
                             device="cpu")


def _staggered(cb, prompts):
    """Three sessions at different steps over two lanes: the third queues."""
    sids = [cb.submit(prompts[0])]
    cb.step()
    cb.step()
    sids.append(cb.submit(prompts[1]))
    cb.step()
    sids.append(cb.submit(prompts[2]))
    return sids, cb.run()


PROMPTS = [_prompt(6, 1), _prompt(9, 2), _prompt(4, 3)]


def test_three_staggered_sessions_match_serial():
    sids, finished = _staggered(_batcher(), PROMPTS)
    assert set(finished) == set(sids)
    for sid, prompt in zip(sids, PROMPTS):
        assert finished[sid].tokens == _serial(prompt, 8), sid
        assert finished[sid].done


def test_eviction_frees_the_lane_for_a_queued_request():
    cb = _batcher(lanes=1, max_new=4)
    a, b = cb.submit(_prompt(5, 10)), cb.submit(_prompt(5, 11))
    assert cb.active_lanes == 0 and len(cb.queue) == 2
    cb.step()
    assert cb.active_lanes == 1 and len(cb.queue) == 1
    finished = cb.run()
    assert set(finished) == {a, b} and cb.active_lanes == 0
    assert finished[a].tokens == _serial(_prompt(5, 10), 4)
    assert finished[b].tokens == _serial(_prompt(5, 11), 4)


def test_admission_is_step_granular():
    cb = _batcher(max_new=16)
    cb.submit(_prompt(6, 20))
    cb.step()
    assert cb.active_lanes == 1
    cb.submit(_prompt(6, 21))
    cb.step()            # admitted while the first session still decodes
    assert cb.active_lanes == 2 and not cb.finished


def test_refuses_the_unrolled_serving_params():
    qp = quantize_llama_host(tl.llama_init(torch.Generator().manual_seed(0), CFG, device="cpu"),
                             device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        ContinuousBatcher(qp, CFG, device="cpu")


def test_overflow_guard():
    cb = _batcher(lanes=1, cache_len=32, max_new=30)
    cb.submit(_prompt(10, 30))
    with pytest.raises(ValueError, match="cache_len 32"):
        cb.step()
    cb = _batcher(lanes=1, cache_len=32, max_new=4)
    cb.submit(_prompt(33, 31))            # its bucket of 64 rows does not fit
    with pytest.raises(ValueError, match="bucketed prompt 64"):
        cb.step()


def test_one_token_budget_emits_exactly_one():
    dp = DecodeParams(max_new_tokens=8, eos_token_id=-1)
    cb = ContinuousBatcher(PARAMS, CFG, lanes=2, cache_len=96, dp=dp, device="cpu")
    sid = cb.submit(list(range(3, 10)), max_new_tokens=1)
    assert len(cb.run()[sid].tokens) == 1 and cb.active_lanes == 0
    sid = cb.submit(list(range(3, 12)), max_new_tokens=3)
    assert len(cb.run()[sid].tokens) == 3
    rb = RingBatcher(PARAMS, CFG, lanes=2, cache_len=96, prompt_len=32, dp=dp, device="cpu")
    sid = rb.submit(list(range(3, 10)), max_new_tokens=1)
    assert len(rb.run()[sid].tokens) == 1


def test_sessions_equal_the_jax_continuous_batcher():
    """The staggered schedule on both packages, with an image session in
    the mix (its embeddings spliced at admission through the LoRA's
    img_proj), a longer budget and EOS disabled."""
    lora = jl.lora_init(jax.random.PRNGKey(1), jl.TINY_LLAMA)
    tlora = bridge.lora(jax.tree_util.tree_map(np.array, lora), "cpu")
    emb = np.random.default_rng(5).normal(
        size=(1, CFG.num_img_tokens, CFG.qformer_dim)).astype(np.float32)
    prompts = [_prompt(6, 1), _prompt(3, 40) + [CFG.img_token_id] * CFG.num_img_tokens
               + _prompt(30, 41), _prompt(4, 3)]
    embs = [None, emb, None]
    jcb = JBatcher(JPARAMS, jl.TINY_LLAMA, lanes=2, cache_len=128,
                   dp=JDecodeParams(max_new_tokens=12, eos_token_id=-1), lora=lora)
    tcb = ContinuousBatcher(PARAMS, CFG, lanes=2, cache_len=128,
                            dp=DecodeParams(max_new_tokens=12, eos_token_id=-1), lora=tlora,
                            device="cpu")
    out = []
    for cb, conv in ((jcb, jnp.asarray), (tcb, torch.from_numpy)):
        sids = [cb.submit(prompts[0])]
        cb.step()
        sids.append(cb.submit(prompts[1], img_embs=conv(embs[1])))
        cb.step()
        sids.append(cb.submit(prompts[2]))
        finished = cb.run()
        out.append([finished[s].tokens for s in sids])
    assert out[1] == out[0] and all(len(t) == 12 for t in out[1])
    # the image changes the session
    plain = ContinuousBatcher(PARAMS, CFG, lanes=1, cache_len=128,
                              dp=DecodeParams(max_new_tokens=12, eos_token_id=-1), lora=tlora,
                              device="cpu")
    sid = plain.submit(prompts[1])
    assert plain.run()[sid].tokens != out[1][1]
