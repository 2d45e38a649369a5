"""Sampling of the PyTorch port's batch engine and its PRNG policy
(radialog_tpu_torch/decode/engine.py ``_select_token``, ``decode_loop``;
radialog_tpu_torch/core/prng.py) against the JAX package.

``jax.random`` and ``torch.Generator`` give other numbers from one seed, so
the port's noise function ``gumbel_noise`` is replaced with JAX's own
noise, in the order the JAX engine draws it; then the tokens must be equal.
The logits of each case are checked to hold no cumulative mass within 1e-6
of top_p, so that a last-ulp difference in the cumsum cannot flip the
nucleus cut."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.core import prng as jprng
from radialog_tpu.decode import engine as je
from radialog_tpu.models import llama as jl
from radialog_tpu_torch.core import prng as tprng
from radialog_tpu_torch.decode import engine as te
from radialog_tpu_torch.models import llama as tl

import test_torch_llama as tll

B, V = 4, 256


def _feed(monkeypatch, noises):
    """Replace the port's noise with the given arrays, one per call."""
    it = iter(noises)

    def fed(shape, gen, device):
        x = torch.from_numpy(np.array(next(it))).to(device)
        assert tuple(x.shape) == tuple(shape)
        return x
    monkeypatch.setattr(te, "gumbel_noise", fed)


@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5])
@pytest.mark.parametrize("top_k", [0, 1, 5])
def test_select_token_matches_jax(monkeypatch, top_k, top_p):
    rng = np.random.default_rng(top_k * 10 + int(top_p * 10))
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    dp_j = je.DecodeParams(do_sample=True, temperature=0.7, top_k=top_k, top_p=top_p)
    dp_t = te.DecodeParams(do_sample=True, temperature=0.7, top_k=top_k, top_p=top_p)
    # no cumulative mass of the tempered, top-k-filtered logits near the cut
    x = np.sort(logits / np.float32(0.7), axis=-1)[:, ::-1].astype(np.float64)
    if top_k:
        x[:, top_k:] = -np.inf
    p = np.exp(x - x[:, :1])
    cum = np.cumsum(p / p.sum(-1, keepdims=True), -1)
    assert top_p == 1.0 or np.abs(cum - top_p).min() > 1e-6
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(je._select_token(jnp.asarray(logits), dp_j, key))
        _feed(monkeypatch, [jax.random.gumbel(key, (B, V), jnp.float32)])
        got = te._select_token(torch.from_numpy(logits), dp_t, None)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert got.dtype == torch.int32
    if top_k == 1:
        np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


@pytest.mark.parametrize("temperature", [0.7, 0.3, 1.3])
def test_sampling_logits_divide_as_jax(temperature):
    """``sampling_logits`` divides by the temperature as an IEEE f32
    division (``div_scalar``), bitwise JAX's ``logits / temperature`` and
    numpy's, and keeps exactly the top-k and nucleus sets (held on the card
    against the CPU by tests/test_torch_kernels_cuda.py, where a division by
    a Python scalar multiplies by its reciprocal)."""
    logits = (np.random.default_rng(3).normal(size=(B, V)) * 3).astype(np.float32)
    want = np.asarray(jnp.asarray(logits) / temperature)
    np.testing.assert_array_equal(want, logits / np.float32(temperature))
    got = te.sampling_logits(torch.from_numpy(logits),
                             te.DecodeParams(do_sample=True, temperature=temperature))
    np.testing.assert_array_equal(got.numpy(), want)
    top5 = te.sampling_logits(torch.from_numpy(logits), te.DecodeParams(
        do_sample=True, temperature=temperature, top_k=5)).numpy()
    np.testing.assert_array_equal(np.sort(np.argsort(-top5, -1)[:, :5], -1),
                                  np.sort(np.argsort(-logits, -1)[:, :5], -1))
    assert ((top5 > te.NEG_INF).sum(-1) == 5).all()
    nucleus = te.sampling_logits(torch.from_numpy(logits), te.DecodeParams(
        do_sample=True, temperature=temperature, top_p=0.9)).numpy()
    x = np.sort(want, -1)[:, ::-1].astype(np.float64)
    p = np.exp(x - x[:, :1])
    p /= p.sum(-1, keepdims=True)
    kept = ((np.cumsum(p, -1) - p) < 0.9).sum(-1)
    np.testing.assert_array_equal((nucleus > te.NEG_INF).sum(-1), kept)


def _jax_noise(seed: int, steps: int):
    """The JAX engine's noise: key0 for the first token, then one split per
    decode step (radialog_tpu/decode/engine.py decode loop)."""
    key = jax.random.PRNGKey(seed)
    out = [jax.random.gumbel(key, (3, jl.TINY_LLAMA.vocab_size), jnp.float32)]
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(jax.random.gumbel(sub, (3, jl.TINY_LLAMA.vocab_size), jnp.float32))
    return out


# weights of seed 2 cross no int8 rounding edge in these runs
WEIGHT_SEED = 2


@pytest.mark.parametrize("kv_int8", [True, False])
def test_sampled_generate_matches_jax(monkeypatch, kv_int8):
    monkeypatch.setenv("RADIALOG_FLASH_DECODE_FORCE", "interpret")
    qp, lora, tp, tlora, _ = tll.models(WEIGHT_SEED)
    rng = np.random.default_rng(3)
    toks = rng.integers(3, 200, (3, 8)).astype(np.int32)
    lens = np.asarray([8, 5, 7], np.int32)
    new, seed = 7, 11
    dp_j = je.DecodeParams(max_new_tokens=new, eos_token_id=-1, do_sample=True,
                           temperature=0.8, seed=seed)
    dp_t = te.DecodeParams(max_new_tokens=new, eos_token_id=-1, do_sample=True,
                           temperature=0.8, seed=seed)
    ref = je.generate_jit(qp, jl.TINY_LLAMA, jnp.asarray(toks), jnp.asarray(lens), dp_j,
                          lora=lora, cache_len=16, kv_int8=kv_int8)
    _feed(monkeypatch, _jax_noise(seed, new - 1))
    got = te.generate(tp, tl.TINY_LLAMA, torch.from_numpy(toks), torch.from_numpy(lens),
                      dp_t, lora=tlora, cache_len=16, kv_int8=kv_int8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    greedy = te.generate(tp, tl.TINY_LLAMA, torch.from_numpy(toks), torch.from_numpy(lens),
                         te.DecodeParams(max_new_tokens=new, eos_token_id=-1), lora=tlora,
                         cache_len=16, kv_int8=kv_int8)
    assert not torch.equal(got.tokens, greedy.tokens)        # the noise mattered


def test_own_generator_repeats_for_one_seed():
    _, _, tp, tlora, _ = tll.models(0)
    toks = torch.randint(3, 200, (2, 6), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    lens = torch.tensor([6, 4], dtype=torch.int32)
    runs = [te.generate(tp, tl.TINY_LLAMA, toks, lens,
                        te.DecodeParams(max_new_tokens=6, eos_token_id=-1, do_sample=True,
                                        top_k=20, top_p=0.9, seed=s), lora=tlora, cache_len=16)
            for s in (5, 5, 6)]
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    assert not torch.equal(runs[0].tokens, runs[2].tokens)


def test_eos_lanes_keep_emitting_eos(monkeypatch):
    """A lane that samples EOS keeps emitting it, and its length stops there."""
    _, _, tp, tlora, _ = tll.models(0)
    v = tl.TINY_LLAMA.vocab_size
    noise = [np.zeros((2, v), np.float32) for _ in range(5)]
    noise[1][0, 2] = 1e12                       # lane 0 samples EOS (id 2) at step 1
    _feed(monkeypatch, noise)
    res = te.generate(tp, tl.TINY_LLAMA, torch.full((2, 4), 7, dtype=torch.int32),
                      torch.tensor([4, 3], dtype=torch.int32),
                      te.DecodeParams(max_new_tokens=5, eos_token_id=2, do_sample=True),
                      lora=tlora, cache_len=16)
    assert res.tokens[0, 1:].tolist() == [2] * 4 and int(res.lengths[0]) == 2


def test_prng_matches_jax_policy():
    for name in ("", "dropout", "data/shuffle", "ü-name", "x" * 100):
        assert tprng._stable_hash(name) == jprng._stable_hash(name)
    seq = tprng.PRNGSeq(42, device="cpu")
    a, b = torch.rand(8, generator=seq("dropout")), torch.rand(8, generator=seq("dropout"))
    c, d = torch.rand(8, generator=seq()), torch.rand(8, generator=seq())
    assert torch.equal(a, b) and not torch.equal(c, d) and not torch.equal(a, c)
    again = tprng.PRNGSeq(42, device="cpu")
    assert torch.equal(torch.rand(8, generator=again()), c)
    u = tprng.uniform_like(seq("u"), torch.zeros(3, 2))
    assert u.shape == (3, 2) and u.dtype == torch.float32 and bool(((u >= 0) & (u < 1)).all())
