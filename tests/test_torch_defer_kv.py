"""In-kernel KV writes of the PyTorch port (K2'': flash-decode's ``current``
/ ``write_cache`` mode, and ``llama_apply(defer_kv=True)``) against the JAX
package, whose flash-decode kernel runs in Pallas interpret mode.

Tolerances: the outputs and logits within 1e-5. Both walk the same blocks
in the same order (prefix, current row, lane blocks), the int32 scores are
exact and the f32 softmax agrees to a few ulp; the cases and weight seeds
below cross no bf16 rounding of p * vs and no int8 rounding edge of an
activation (where one would, one ulp moves a logit by a quantization step:
tests/test_torch_llama.py). The written rows are held bitwise. The port
writes only the slot row; the JAX kernel rebuilds an 8-row slab and leaves
the rows above the slot undefined, so every other row is held to the
port's stronger contract: unchanged."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.decode import engine as je
from radialog_tpu.models import llama as jl
from radialog_tpu.ops.flash_decode import flash_decode_int8 as jflash
from radialog_tpu_torch import bridge
from radialog_tpu_torch.decode import engine as te
from radialog_tpu_torch.models import llama as tl
from radialog_tpu_torch.ops import flash_decode as tfd

import test_torch_llama as tll

L, B, S, H, D = 2, 3, 32, 4, 8
P0, P0P = 11, 16
OUT_TOL = dict(rtol=0, atol=1e-5)


def _cache(seed):
    rng = np.random.default_rng(seed)
    k8, ks = jl.quantize_kv(jnp.asarray(rng.normal(size=(L, B, S, H, D)), jnp.float32))
    v8, vs = jl.quantize_kv(jnp.asarray(rng.normal(size=(L, B, S, H, D)), jnp.float32))
    k0, ks0 = jl.quantize_kv(jnp.asarray(rng.normal(size=(P0P, H, D)), jnp.float32))
    v0, vs0 = jl.quantize_kv(jnp.asarray(rng.normal(size=(P0P, H, D)), jnp.float32))
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    cache = [np.asarray(k8).reshape(L, B, S, H * D), np.asarray(ks),
             np.asarray(v8).reshape(L, B, S, H * D), np.asarray(vs)]
    shared = [np.asarray(k0).reshape(P0P, H * D), np.asarray(ks0),
              np.asarray(v0).reshape(P0P, H * D), np.asarray(vs0)]
    return q, cache, shared


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("step", [0, 3, 11])
def test_write_cache_matches_pallas_interpret(shared, step):
    """The shapes of tests/test_kv_int8.py's write_cache cases: slots 12
    (step 0: an empty generated interval), 15 and 23 (the last row of an
    8-row slab), bs=8, with and without a 16-row prefix of 11 live rows."""
    q, cache, pre = _cache(11 + shared)
    lengths = np.asarray([5, 12, 9], np.int32)
    prompt_pad, li = 12, 1
    slot = prompt_pad + step
    cur = [x[li, :, slot:slot + 1].copy() for x in cache]
    # zero the slot row of every layer so that a missing or misplaced write shows
    zeroed = [x.copy() for x in cache]
    for x in zeroed:
        x[:, :, slot] = 0
    kw_j = dict(shared=tuple(jnp.asarray(x)[None] for x in pre), p0=P0) if shared else {}
    ref, jnew = jflash(jnp.asarray(q), *(jnp.asarray(x) for x in zeroed), jnp.asarray(lengths),
                       prompt_pad, step - 1, layer_idx=li, bs=8, interpret=True,
                       current=tuple(jnp.asarray(x) for x in cur), write_cache=True, **kw_j)
    tcache = bridge.to_torch([x.copy() for x in zeroed], device="cpu")
    kw_t = dict(shared=bridge.to_torch(pre, device="cpu"), p0=P0) if shared else {}
    got, tnew = tfd.flash_decode_int8(torch.from_numpy(q), *tcache, torch.from_numpy(lengths),
                                      prompt_pad, step - 1, layer_idx=li, bs=8,
                                      current=bridge.to_torch(cur, device="cpu"),
                                      write_cache=True, **kw_t)
    assert all(a is b for a, b in zip(tnew, tcache))          # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OUT_TOL)
    for new, jn, old, c in zip(tnew, jnew, zeroed, cur):
        new = new.float().numpy() if new.dtype == torch.bfloat16 else new.numpy()
        jn, old, c = (np.asarray(x, np.float32 if new.dtype == np.float32 else x.dtype)
                      for x in (jn, old, c))
        np.testing.assert_array_equal(new[li, :, slot], c[:, 0])
        np.testing.assert_array_equal(new[li, :, slot], jn[li, :, slot])
        untouched = np.ones(new.shape[:3], bool)
        untouched[li, :, slot] = False
        np.testing.assert_array_equal(new[untouched], old[untouched])


def test_current_row_order_matches_reading_it_from_the_cache():
    """The current row attended as an operand gives the output of the same
    row read back from the cache (K2 with the mask one slot longer)."""
    q, cache, pre = _cache(5)
    tq = torch.from_numpy(q)
    tcache = bridge.to_torch(cache, device="cpu")
    lens = torch.tensor([5, 12, 9], dtype=torch.int32)
    cur = [x[1, :, 14:15].clone() for x in tcache]
    ref = tfd.flash_decode_int8(tq, *tcache, lens, 12, 2, layer_idx=1, bs=8)
    got = tfd.flash_decode_int8(tq, *tcache, lens, 12, 1, layer_idx=1, bs=8, current=cur)
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-3)


def test_write_cache_refuses_a_slot_past_the_cache():
    q, cache, _ = _cache(1)
    tcache = bridge.to_torch(cache, device="cpu")
    cur = [x[0, :, :1].clone() for x in tcache]
    lens = torch.tensor([5, 12, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="past"):
        tfd.flash_decode_int8(torch.from_numpy(q), *tcache, lens, 12, S - 13, bs=8,
                              current=cur, write_cache=True)
    with pytest.raises(ValueError, match="static-slot"):
        tfd.flash_decode_int8(torch.from_numpy(q), *tcache, lens, bs=8, current=cur,
                              write_cache=True, gen_intervals=(lens, lens, lens, lens))


# ----------------------------------------------------------- llama_apply
T, NSTEP, SLEN = 8, 3, 16
# weights of seed 2 cross no int8 rounding edge in these steps; at seed 1
# one activation ulp moves logits by up to 0.072 (a quantization step)
WEIGHT_SEED = 2


def _setup(prefix: bool):
    qp, lora, tp, tlora, _ = tll.models(WEIGHT_SEED)
    rng = np.random.default_rng(7)
    toks = rng.integers(3, 200, (B, T)).astype(np.int32)
    lens = np.asarray([8, 6, 7], np.int32)
    forced = rng.integers(3, 200, (B, NSTEP)).astype(np.int32)
    cfg_j, cfg_t = jl.TINY_LLAMA, tl.TINY_LLAMA
    if not prefix:
        jcache, _ = je.prefill(qp, cfg_j, jnp.asarray(toks), jnp.asarray(lens), SLEN,
                               lora=lora, kv_int8=True)
        tcache, _ = te.prefill(tp, cfg_t, torch.from_numpy(toks), torch.from_numpy(lens), SLEN,
                               lora=tlora)
        return qp, lora, tp, tlora, jcache, tcache, lens, forced, {}, {}, 0
    ptoks = rng.integers(3, 200, (6,)).astype(np.int32)
    jshared = je.prefix_kv(qp, cfg_j, jnp.asarray(ptoks), lora=lora)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1)) + 6
    _, jcache = jl.llama_apply(qp, cfg_j, jnp.asarray(toks), jnp.asarray(pos),
                               jl.prefill_bias(jnp.asarray(lens), T),
                               cache=jl.init_cache(cfg_j, B, SLEN, quantized=True),
                               write_pos=0, lora=lora, lengths=jnp.asarray(lens),
                               last_pos=jnp.asarray(lens - 1), shared_kv=jshared)
    tshared = te.prefix_kv(tp, cfg_t, torch.from_numpy(ptoks), lora=tlora)
    _, tcache = tl.llama_apply(tp, cfg_t, torch.from_numpy(toks), torch.from_numpy(pos),
                               tl.prefill_bias(torch.from_numpy(lens), T),
                               cache=tl.init_cache(cfg_t, B, SLEN, device="cpu"),
                               lora=tlora, lengths=torch.from_numpy(lens),
                               last_pos=torch.from_numpy(lens - 1), shared_kv=tshared)
    k0, ks0 = jl.quantize_kv(jshared.k)
    v0, vs0 = jl.quantize_kv(jshared.v)
    pad = ((0, 0), (0, 32 - 6), (0, 0))
    nl = k0.shape[0]
    k0 = jnp.pad(k0.reshape(nl, 6, -1), pad)
    v0 = jnp.pad(v0.reshape(nl, 6, -1), pad)
    ks0, vs0 = (jnp.pad(jl.pad_scale_lanes(x), pad) for x in (ks0, vs0))
    jkw = dict(shared_kv=tuple((k0[i], ks0[i], v0[i], vs0[i]) for i in range(nl)), shared_p0=6)
    tkw = dict(shared_kv=te.quantize_prefix(tshared), shared_p0=6)
    return qp, lora, tp, tlora, jcache, tcache, lens, forced, jkw, tkw, 6


@pytest.mark.parametrize("prefix", [False, True])
def test_llama_apply_defer_matches_jax(monkeypatch, prefix):
    """Three decode steps with in-kernel writes after an int8 prefill, the
    JAX step jitted as the engine's loop body traces it (eager and jitted
    JAX differ, ROADMAP §4)."""
    monkeypatch.setenv("RADIALOG_FLASH_DECODE_FORCE", "interpret")
    qp, lora, tp, tlora, jcache, tcache, lens, forced, jkw, tkw, off = _setup(prefix)
    jlens, tlens = jnp.asarray(lens), torch.from_numpy(lens)

    @jax.jit
    def jstep(cache, tok, step):
        return jl.llama_apply(qp, jl.TINY_LLAMA, tok[:, None], (jlens + off + step)[:, None],
                              jl.decode_bias_static_slot(jlens, T, step, SLEN), cache=cache,
                              write_pos=T + step, lora=lora, lengths=jlens,
                              slot_info=(T, step), defer_kv=True, **jkw)

    for step in range(NSTEP):
        jlog, jcache = jstep(jcache, jnp.asarray(forced[:, step]), jnp.asarray(step))
        tlog, tcache = tl.llama_apply(tp, tl.TINY_LLAMA, torch.from_numpy(forced[:, step:step + 1]),
                                      (tlens + off + step)[:, None], None, cache=tcache,
                                      write_pos=T + step, lora=tlora, lengths=tlens,
                                      slot_info=(T, step), defer_kv=True, **tkw)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **OUT_TOL)
        for name in ("k", "v", "k_scale", "v_scale"):
            j = np.asarray(getattr(jcache, name).astype(jnp.float32))[:, :, T + step]
            t = getattr(tcache, name)[:, :, T + step].float().numpy()
            np.testing.assert_array_equal(t, j[..., :t.shape[-1]], err_msg=f"{name} step {step}")


def test_defer_matches_per_layer_writes():
    """The port's in-kernel writes against its row copies (tests/test_kv_int8.py's
    bounds): layer 0 sees the same inputs both ways, so its slot rows are
    bitwise equal; later layers carry the attention's other order of sums,
    so the logits are held within 0.15 of their std; then a greedy
    ``generate`` end to end both ways."""
    qp, lora, tp, tlora, _, tcache, lens, forced, _, _, _ = _setup(False)
    tlens = torch.from_numpy(lens)
    c_def = tcache
    c_per = tl.KVCache(*(x.clone() for x in (tcache.k, tcache.v, tcache.k_scale,
                                             tcache.v_scale)))
    for step in range(NSTEP):
        args = (tp, tl.TINY_LLAMA, torch.from_numpy(forced[:, step:step + 1]),
                (tlens + step)[:, None], None)
        kw = dict(write_pos=T + step, lora=tlora, lengths=tlens, slot_info=(T, step))
        lo_d, c_def = tl.llama_apply(*args, cache=c_def, defer_kv=True, **kw)
        lo_p, c_per = tl.llama_apply(*args, cache=c_per, defer_kv=False, **kw)
        err = float((lo_d - lo_p).abs().max() / lo_p.std())
        assert err < 0.15, f"step {step}: {err:.3f} sigma"
        for name in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(getattr(c_def, name)[0, :, T + step],
                               getattr(c_per, name)[0, :, T + step]), name
    dp = te.DecodeParams(max_new_tokens=4, eos_token_id=-1)
    res = {}
    for defer in ("1", "0"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RADIALOG_DEFER_KV", defer)
            res[defer] = te.generate(tp, tl.TINY_LLAMA, torch.from_numpy(forced),
                                     torch.tensor([3, 2, 3], dtype=torch.int32), dp,
                                     lora=tlora, cache_len=16)
    assert res["1"].tokens.shape == (B, 4)
    assert torch.equal(res["1"].tokens, res["0"].tokens)


def test_defer_checks_write_pos_and_reads_the_env(monkeypatch):
    _, _, tp, tlora, _, tcache, lens, forced, _, _, _ = _setup(False)
    tlens = torch.from_numpy(lens)
    args = (tp, tl.TINY_LLAMA, torch.from_numpy(forced[:, :1]), tlens[:, None], None)
    with pytest.raises(ValueError, match="write_pos"):
        tl.llama_apply(*args, cache=tcache, write_pos=T + 1, lora=tlora, lengths=tlens,
                       slot_info=(T, 0), defer_kv=True)
    seen = []
    real = tl.flash_decode_int8

    def spy(*a, **kw):
        seen.append(kw.get("write_cache", False))
        return real(*a, **kw)
    monkeypatch.setattr(tl, "flash_decode_int8", spy)
    for env, want in (("1", True), ("0", False), (None, False)):
        if env is None:
            monkeypatch.delenv("RADIALOG_DEFER_KV", raising=False)
        else:
            monkeypatch.setenv("RADIALOG_DEFER_KV", env)
        seen.clear()
        tl.llama_apply(*args, cache=tcache, write_pos=T, lora=tlora, lengths=tlens,
                       slot_info=(T, 0))
        assert seen == [want] * tl.TINY_LLAMA.num_layers, env
    # an explicit argument wins over the env; the ring's intervals never defer
    monkeypatch.setenv("RADIALOG_DEFER_KV", "1")
    seen.clear()
    tl.llama_apply(*args, cache=tcache, write_pos=T, lora=tlora, lengths=tlens,
                   slot_info=(T, 0), defer_kv=False)
    iv = tuple(torch.full((B,), x, dtype=torch.int32) for x in (T, T, 0, -1))
    tl.llama_apply(*args, cache=tcache, write_pos=T, lora=tlora, lengths=tlens, slot_info=iv)
    assert seen == [False] * (2 * tl.TINY_LLAMA.num_layers)
