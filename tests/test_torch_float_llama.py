"""The float path's model and engine of the PyTorch port against the JAX
package: ``llama_apply`` on the stacked layout (``llama_init``'s float tree)
with the bf16 KV cache, and ``generate(kv_int8=False)`` on those params, at
TINY_LLAMA, FP32 policy, weights and a LoRA with a nonzero B through the
bridge; the JAX side jitted.

Tolerances: cache rows: both round their f32 K/V to bf16, equal but where
an f32 value sits on a bf16 rounding edge: those elements one bf16 step
apart (relative 2^-7), at most one in a thousand (measured: 1 of 12,288).
Logits (std ~0.6) within 5e-5: f32 sums in another order give up to 6e-6,
and a cached element one bf16 step apart read by a later forward 2.0e-5
(measured). Over a
prompt of 256 tokens or more the port's prefill runs K3's plain version
where JAX (off a TPU) runs ``mha``: teacher-forced logits within 2e-4 there
(measured 6.8e-5: the prefill's K/V differ in f32 rounding, and the values
on a bf16 edge install one step apart) and greedy tokens equal up to the
first step where JAX's top two logits are within 1e-3."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.decode import engine as je
from radialog_tpu.models import llama as jl
from radialog_tpu_torch import bridge
from radialog_tpu_torch.decode import engine as te
from radialog_tpu_torch.models import llama as tl
from radialog_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=0, atol=5e-5)
LONG_TOL = 2e-4
NEAR_TIE = 1e-3
# max_position covers the 260-token prompt and its decode
JCFG = dataclasses.replace(jl.TINY_LLAMA, max_position=512)
TCFG = dataclasses.replace(tl.TINY_LLAMA, max_position=512)
B, S = 3, 32


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def models():
    params = jl.llama_init(jax.random.PRNGKey(0), JCFG)
    lora = jl.lora_init(jax.random.PRNGKey(1), JCFG)
    rng = np.random.default_rng(0)
    for t in lora["layers"]:
        lora["layers"][t]["b"] = jnp.asarray(
            rng.normal(size=lora["layers"][t]["b"].shape).astype(np.float32) * 0.1)
    return (params, lora, bridge.llama_stacked(_np(params), "cpu"),
            bridge.lora(_np(lora), "cpu"))


def _assert_rows(tcache, jcache):
    """Every cache row: equal, or one bf16 step apart at a rounding edge."""
    for name in ("k", "v"):
        got = getattr(tcache, name).float().numpy()
        want = np.asarray(getattr(jcache, name).astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
        assert (got != want).mean() <= 1e-3, name


def _caches(seed=0):
    """The same random bf16 cache on both sides: (JAX KVCache, port KVCache)."""
    rng = np.random.default_rng(seed)
    shape = (JCFG.num_layers, B, S, JCFG.num_kv_heads, JCFG.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    return (jl.KVCache(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)),
            tl.KVCache(torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()))


_jstep = jax.jit(lambda p, tok, pos, bias, cache, wp, lora: jl.llama_apply(
    p, JCFG, tok, pos, bias, cache=cache, write_pos=wp, lora=lora))


def _both(models, jcache, tcache, tok, pos, bias, write_pos):
    """One forward over the cache on each side; asserts logits and every
    cache row, returns the updated caches."""
    params, lora, tp, tlora = models
    jlog, jcache = _jstep(params, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(bias),
                          jcache, jnp.asarray(write_pos), lora)
    wp = torch.from_numpy(np.array(write_pos)) if np.ndim(write_pos) else int(write_pos)
    with torch.no_grad():
        tlog, out = tl.llama_apply(tp, TCFG, torch.from_numpy(tok), torch.from_numpy(pos),
                                   torch.from_numpy(bias), cache=tcache, write_pos=wp,
                                   lora=tlora)
    assert out is tcache and tlog.shape == tuple(jlog.shape)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_rows(tcache, jcache)
    return jcache, tcache


def test_decode_step_with_a_scalar_write_pos_matches_jax(models):
    """Every lane writes slot 12 and attends the whole layer cache under
    the static-slot bias (prompts of 5, 9 and 11 tokens padded to 12)."""
    jcache, tcache = _caches(1)
    lens = np.asarray([5, 9, 11], np.int32)
    rng = np.random.default_rng(2)
    for step in range(2):
        tok = rng.integers(3, 200, (B, 1)).astype(np.int32)
        bias = np.array(jl.decode_bias_static_slot(jnp.asarray(lens), 12, step, S))
        jcache, tcache = _both(models, jcache, tcache, tok, (lens + step)[:, None], bias,
                               12 + step)


def test_decode_step_with_a_vector_write_pos_matches_jax(models):
    """Lanes at different lengths each write their own row (the
    ContinuousBatcher step: write_pos = cur_lens, decode_bias(cur_lens + 1))."""
    jcache, tcache = _caches(3)
    cur = np.asarray([4, 17, 30], np.int32)
    rng = np.random.default_rng(4)
    for _ in range(2):
        tok = rng.integers(3, 200, (B, 1)).astype(np.int32)
        bias = np.array(jl.decode_bias(jnp.asarray(cur + 1), S))
        jcache, tcache = _both(models, jcache, tcache, tok, cur[:, None], bias, cur)
        cur = cur + 1


def test_a_block_of_three_tokens_attends_the_whole_cache(models):
    """t = 3 over a filled cache: the stacked layout attends every cache
    row under the caller's bias (it is not the unrolled layout's direct
    prefill); at a scalar slot and at per-lane slots."""
    jcache, tcache = _caches(5)
    rng = np.random.default_rng(6)
    tok = rng.integers(3, 200, (B, 3)).astype(np.int32)
    pos = np.tile(np.arange(20, 23, dtype=np.int32), (B, 1))
    causal = (np.arange(S)[None] <= np.arange(20, 23)[:, None])
    bias = np.where(causal, 0.0, -1e9).astype(np.float32)[None, None]
    jcache, tcache = _both(models, jcache, tcache, tok, pos, bias, 20)
    start = np.asarray([2, 11, 26], np.int32)
    pos = start[:, None] + np.arange(3, dtype=np.int32)[None]
    bias = np.where(np.arange(S)[None, None] <= pos[:, :, None], 0.0, -1e9)
    _both(models, jcache, tcache, tok, pos, bias.astype(np.float32)[:, None], start)


def test_the_stacked_layout_refuses_the_int8_cache_and_a_shared_prefix(models):
    params, _, tp, tlora = models
    tok = torch.ones((1, 4), dtype=torch.int32)
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="unrolled serving params"):
        tl.llama_apply(tp, TCFG, tok, pos, None, cache=tl.init_cache(TCFG, 1, 32, device="cpu"))
    shared = tl.PrefixKV(torch.zeros(2, 3, 4, 16), torch.zeros(2, 3, 4, 16))
    with pytest.raises(ValueError, match="shared_kv"):
        tl.llama_apply(tp, TCFG, tok, pos, None, shared_kv=shared)
    lens = torch.tensor([4])
    with pytest.raises(ValueError, match="unrolled weight layout"):
        te.generate_shared_prefix(tp, TCFG, torch.arange(3, 23), tok, lens,
                                  te.DecodeParams(max_new_tokens=3), kv_int8=False)
    with pytest.raises(ValueError, match="unrolled weight layout"):   # the JAX engine's
        je.generate_shared_prefix(params, JCFG, jnp.arange(3, 23), jnp.ones((1, 4), jnp.int32),
                                  jnp.asarray([4]), je.DecodeParams(max_new_tokens=3))
    # the int8 cache (the port's default) reaches the first decode step
    with pytest.raises(ValueError, match="unrolled serving params"):
        te.generate(tp, TCFG, tok, lens, te.DecodeParams(max_new_tokens=3))


def _prompts(lens, t, seed, img=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, 200, (len(lens), t)).astype(np.int32)
    if img:
        toks[:, 2:2 + JCFG.num_img_tokens] = JCFG.img_token_id
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    emb = rng.normal(size=(len(lens), JCFG.num_img_tokens, JCFG.qformer_dim))
    return toks, np.asarray(lens, np.int32), emb.astype(np.float32)


def test_generate_matches_jax_generate_jit(models):
    """Batch 3 with image embeddings and the LoRA: the install_prefill'd
    cache, the first logits and the greedy tokens."""
    params, lora, tp, tlora = models
    toks, lens, emb = _prompts([12, 7, 10], 12, 7)
    dp = te.DecodeParams(max_new_tokens=8, eos_token_id=-1)
    jdp = je.DecodeParams(max_new_tokens=8, eos_token_id=-1)
    jcache, jfirst = je.prefill(params, JCFG, jnp.asarray(toks), jnp.asarray(lens), S,
                                img_embs=jnp.asarray(emb), lora=lora)
    with torch.no_grad():
        tcache, tfirst = te.prefill(tp, TCFG, torch.from_numpy(toks), torch.from_numpy(lens), S,
                                    img_embs=torch.from_numpy(emb), lora=tlora, kv_int8=False)
        got = te.generate(tp, TCFG, torch.from_numpy(toks), torch.from_numpy(lens), dp,
                          img_embs=torch.from_numpy(emb), lora=tlora, cache_len=S,
                          kv_int8=False)
    np.testing.assert_allclose(tfirst.numpy(), np.asarray(jfirst), **TOL)
    _assert_rows(tcache, jcache)
    want = je.generate_jit(params, JCFG, jnp.asarray(toks), jnp.asarray(lens), jdp,
                           img_embs=jnp.asarray(emb), lora=lora, cache_len=S)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


def _jax_forced(params, lora, toks, lens, emb, forced, s):
    """JAX's prefill and decode steps teacher-forced with ``forced``;
    returns the logits before each forced token, (n, V) per lane."""
    step = jax.jit(lambda p, tok, pos, bias, cache, wp, lo: jl.llama_apply(
        p, JCFG, tok, pos, bias, cache=cache, write_pos=wp, lora=lo))
    cache, logits = je.prefill(params, JCFG, jnp.asarray(toks), jnp.asarray(lens), s,
                               img_embs=jnp.asarray(emb), lora=lora)
    out = [np.asarray(logits)]
    t = toks.shape[1]
    for i, tok in enumerate(forced.T[:-1]):
        bias = jl.decode_bias_static_slot(jnp.asarray(lens), t, i, s)
        logits, cache = step(params, jnp.asarray(tok[:, None]), jnp.asarray(lens + i)[:, None],
                             bias, cache, t + i, lora)
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, axis=1)


def test_a_prompt_of_256_tokens_or_more(models, monkeypatch):
    """K3's plain version (32 x 2 calls: one a layer) against JAX's mha over
    a 260-token prompt: teacher-forced logits of JAX's greedy tokens within
    LONG_TOL, and the port's own greedy tokens equal to JAX's up to the
    first step whose top two JAX logits are within NEAR_TIE."""
    params, lora, tp, tlora = models
    toks, lens, emb = _prompts([260], 264, 8)
    new, s = 12, 384
    calls = []
    plain = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: (calls.append(a[0].shape), plain(*a, **kw))[1])
    jdp = je.DecodeParams(max_new_tokens=new, eos_token_id=-1)
    want = np.asarray(je.generate_jit(params, JCFG, jnp.asarray(toks), jnp.asarray(lens), jdp,
                                      img_embs=jnp.asarray(emb), lora=lora,
                                      cache_len=s).tokens)
    jlog = _jax_forced(params, lora, toks, lens, emb, want, s)
    tt, tlens, temb = (torch.from_numpy(x) for x in (toks, lens, emb))
    with torch.no_grad():
        got = te.generate(tp, TCFG, tt, tlens, te.DecodeParams(max_new_tokens=new, eos_token_id=-1),
                          img_embs=temb, lora=tlora, cache_len=s, kv_int8=False).tokens.numpy()
        assert len(calls) == JCFG.num_layers and calls[0] == (1, 264, 4, 16)
        cache, logits = te.prefill(tp, TCFG, tt, tlens, s, img_embs=temb, lora=tlora,
                                   kv_int8=False)
        tlog = [logits.numpy()]
        for i, tok in enumerate(want.T[:-1]):
            tlog.append(te.decode_step(tp, TCFG, cache, torch.from_numpy(tok.copy()), tlens, 264, i,
                                       lora=tlora).numpy())
    tlog = np.stack(tlog, axis=1)
    err = np.abs(tlog - jlog).max()
    print(f"teacher-forced logits: largest difference {err}")
    assert err < LONG_TOL, err
    top2 = np.sort(jlog[0], axis=-1)[:, -2:]
    ties = np.flatnonzero(top2[:, 1] - top2[:, 0] < NEAR_TIE)
    upto = ties[0] if len(ties) else new
    np.testing.assert_array_equal(got[0, :upto], want[0, :upto])
