"""LLaMA serving path of the PyTorch port against the JAX package at
TINY_LLAMA, W8A8 weights and the int8 KV cache, FP32 policy, weights
through the bridge. The JAX decode takes its flash-decode kernel in Pallas
interpret mode (RADIALOG_FLASH_DECODE_FORCE=interpret), not the int8-pv
XLA fallback, which is a different function.

Tolerance for logits: atol=2e-3 on logits of std ~1. Both sides quantize
activations to int8 per row; an ulp-level float difference can move one
element across a rounding boundary, a 1/127-of-row-max step in one input
of one matmul, which is the size of error this bound admits."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.models import llama as jl
from radialog_tpu.ops.quant import quantize_llama_host as jquantize
from radialog_tpu_torch import bridge
from radialog_tpu_torch.models import llama as tl
from radialog_tpu_torch.ops.quant import quantize_llama_host

CFG_J = jl.TINY_LLAMA
CFG_T = tl.TINY_LLAMA
LOGIT_TOL = dict(rtol=0, atol=2e-3)


def packed_tree(qp):
    """The JAX serving tree, or one leaf of it, as numpy dicts (PackedQ8
    and PackedQ4 -> dict)."""
    def conv(x):
        if type(x).__name__ == "PackedQ4":
            return {"w_t": np.asarray(x.w_t), "gscale": np.asarray(x.gscale), "n": x.n,
                    "group": x.group, "goff": None if x.goff is None else np.asarray(x.goff),
                    "b": None if x.b is None else np.asarray(x.b)}
        if type(x).__name__ == "PackedQ8":
            return {"w_t": np.asarray(x.w_t), "scale": np.asarray(x.scale), "n": x.n,
                    "b": None if x.b is None else np.asarray(x.b)}
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return np.asarray(x)
    return conv(qp)


def models(seed=0):
    """(JAX serving params, JAX lora, port serving params, port lora) with
    a nonzero LoRA B so the adapters change the output."""
    params = jl.llama_init(jax.random.PRNGKey(seed), CFG_J)
    qp = jquantize(jax.tree_util.tree_map(np.asarray, params))
    lora = jl.lora_init(jax.random.PRNGKey(seed + 1), CFG_J)
    rng = np.random.default_rng(seed)
    for t in lora["layers"]:
        lora["layers"][t]["b"] = jnp.asarray(
            rng.normal(size=lora["layers"][t]["b"].shape).astype(np.float32) * 0.1)
    tp = bridge.llama_serving(packed_tree(qp), CFG_T, device="cpu")
    tlora = bridge.lora(jax.tree_util.tree_map(np.asarray, lora), device="cpu")
    return qp, lora, tp, tlora, params


def test_configs_match_jax():
    for name in ("VICUNA_7B", "TINY_LLAMA"):
        assert dataclasses.asdict(getattr(tl, name)) == {
            k: v for k, v in dataclasses.asdict(getattr(jl, name)).items()
            if k != "override_head_dim"}


@pytest.mark.parametrize("scale_dtype", ["bfloat16", "float32"])
def test_quantize_kv_bitwise(scale_dtype):
    x = np.random.default_rng(0).normal(size=(3, 5, 16)).astype(np.float32)
    x[0, 0] = 0.0
    j8, js = jl.quantize_kv(jnp.asarray(x), getattr(jnp, scale_dtype))
    t8, ts = tl.quantize_kv(torch.from_numpy(x), getattr(torch, scale_dtype))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js).astype(np.float32))


def test_init_cache_refuses_gqa_and_is_token_flat():
    with pytest.raises(NotImplementedError):
        tl.init_cache(dataclasses.replace(CFG_T, num_kv_heads=2), 2, 8, device="cpu")
    c = tl.init_cache(CFG_T, 2, 8, device="cpu")
    assert c.k.shape == (2, 2, 8, 64) and c.k_scale.shape == (2, 2, 8, 4)


def test_splice_and_find_img_start():
    tokens = np.asarray([[5, 250, 250, 7, 8], [1, 2, 3, 4, 5], [250, 250, 9, 9, 9]], np.int32)
    emb = np.random.default_rng(1).normal(size=(3, 5, 6)).astype(np.float32)
    img = np.random.default_rng(2).normal(size=(3, 2, 6)).astype(np.float32)
    js = jl.find_img_start(jnp.asarray(tokens), 250)
    ts = tl.find_img_start(torch.from_numpy(tokens), 250)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tl.splice_image_embeddings(torch.from_numpy(emb), torch.from_numpy(img), ts).numpy(),
        np.asarray(jl.splice_image_embeddings(jnp.asarray(emb), jnp.asarray(img), js)))


def test_quantize_llama_host_matches_jax_pack():
    qp, _, tp, _, params = models()
    mine = quantize_llama_host(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    for name in ("wqkv", "wo", "gateup", "down"):
        assert torch.equal(mine["layers"][1][name].w, tp["layers"][1][name].w)
        assert torch.equal(mine["layers"][1][name].scale, tp["layers"][1][name].scale)
    assert torch.equal(mine["lm_head"].w, tp["lm_head"].w)
    assert torch.equal(mine["embed"], tp["embed"])


def _prefill(qp, lora, tp, tlora, tokens, lengths, img, s_len=32):
    b, t = tokens.shape
    bias_j = jl.prefill_bias(jnp.asarray(lengths), t)
    bias_t = tl.prefill_bias(torch.from_numpy(lengths), t)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    jlog, jcache = jl.llama_apply(
        qp, CFG_J, jnp.asarray(tokens), jnp.asarray(pos), bias_j,
        cache=jl.init_cache(CFG_J, b, s_len, quantized=True), write_pos=0,
        img_embs=jnp.asarray(img), img_start=jl.find_img_start(jnp.asarray(tokens), 250),
        lora=lora, lengths=jnp.asarray(lengths), last_pos=jnp.asarray(lengths - 1))
    tlog, tcache = tl.llama_apply(
        tp, CFG_T, torch.from_numpy(tokens), torch.from_numpy(pos), bias_t,
        cache=tl.init_cache(CFG_T, b, s_len, device="cpu"), write_pos=0,
        img_embs=torch.from_numpy(img),
        img_start=tl.find_img_start(torch.from_numpy(tokens), 250), lora=tlora,
        lengths=torch.from_numpy(lengths), last_pos=torch.from_numpy(lengths - 1))
    return jlog, jcache, tlog, tcache


def test_prefill_then_decode_step_match_jax(monkeypatch):
    monkeypatch.setenv("RADIALOG_FLASH_DECODE_FORCE", "interpret")
    qp, lora, tp, tlora, _ = models()
    rng = np.random.default_rng(4)
    tokens = rng.integers(3, 240, (2, 8)).astype(np.int32)
    tokens[:, 2:6] = 250
    lengths = np.asarray([8, 7], np.int32)
    img = rng.normal(size=(2, 4, 32)).astype(np.float32)
    jlog, jcache, tlog, tcache = _prefill(qp, lora, tp, tlora, tokens, lengths, img)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    # the int8 cache rows of the prompt: dequantized values agree to a step
    deq_j = (np.asarray(jcache.k, np.float32).reshape(2, 2, 32, 4, 16)
             * np.asarray(jcache.k_scale.astype(jnp.float32))[..., :4, None])
    deq_t = (tcache.k.float().reshape(2, 2, 32, 4, 16)
             * tcache.k_scale.float()[..., None]).numpy()
    np.testing.assert_allclose(deq_t[:, :, :8], deq_j[:, :, :8], rtol=0, atol=0.05)
    # one decode step: slot 8 = prompt_pad + 0, over the int8 cache via the
    # flash-decode kernel math on both sides
    last = np.asarray([5, 9], np.int32)
    pos = (lengths + 0)[:, None]
    bias = jl.decode_bias_static_slot(jnp.asarray(lengths), 8, 0, 32)
    jstep, _ = jl.llama_apply(qp, CFG_J, jnp.asarray(last[:, None]), jnp.asarray(pos), bias,
                              cache=jcache, write_pos=8, lora=lora,
                              lengths=jnp.asarray(lengths), slot_info=(8, 0))
    tstep, _ = tl.llama_apply(tp, CFG_T, torch.from_numpy(last[:, None]),
                              torch.from_numpy(pos), None, cache=tcache, write_pos=8,
                              lora=tlora, lengths=torch.from_numpy(lengths),
                              slot_info=(8, 0))
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep), **LOGIT_TOL)


def test_cache_free_prefill_returns_fresh_kv():
    qp, lora, tp, tlora, _ = models(1)
    tokens = np.random.default_rng(5).integers(3, 240, (1, 6)).astype(np.int32)
    ln = np.asarray([6], np.int32)
    pos = np.arange(6, dtype=np.int32)[None]
    jlog, jkv = jl.llama_apply(qp, CFG_J, jnp.asarray(tokens), jnp.asarray(pos),
                               jl.prefill_bias(jnp.asarray(ln), 6), lora=lora,
                               lengths=jnp.asarray(ln))
    tlog, tkv = tl.llama_apply(tp, CFG_T, torch.from_numpy(tokens), torch.from_numpy(pos),
                               tl.prefill_bias(torch.from_numpy(ln), 6), lora=tlora,
                               lengths=torch.from_numpy(ln))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    np.testing.assert_allclose(tkv.k.numpy(), np.asarray(jkv.k), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tkv.v.numpy(), np.asarray(jkv.v), rtol=0, atol=1e-4)


# ------------------------------------------------- cache-free prefill and K3
CFG512_J = dataclasses.replace(CFG_J, max_position=512)
CFG512_T = dataclasses.replace(CFG_T, max_position=512)


def _prompt(b, t, seed, img=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, 240, (b, t)).astype(np.int32)
    if img:
        tokens[:, 3:7] = 250
    lengths = np.asarray([t] + [t - 5 - i for i in range(b - 1)], np.int32)
    embs = rng.normal(size=(b, 4, 32)).astype(np.float32)
    return tokens, lengths, embs


def test_use_flash_rule():
    assert tl._use_flash(torch.ones(1), 256)
    assert not tl._use_flash(torch.ones(1), 255)
    assert not tl._use_flash(None, 300)


@pytest.mark.parametrize("t,flash_calls", [(40, 0), (264, 2)])
def test_small_batch_prefill_installs_the_direct_path_cache(monkeypatch, t, flash_calls):
    """Below batch 30 the engine prefills without a cache and installs the
    fresh K/V. Below 256 tokens that leaves the direct path's cache bytes
    and logits exactly; at 256+ the cache-free attention is K3 (its plain
    version here), one call per layer."""
    from radialog_tpu_torch.decode import engine as te
    from radialog_tpu_torch.ops import flash_attention as tfa
    calls = []
    plain = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    _, _, tp, tlora, _ = models(2)
    tokens, lengths, embs = _prompt(3, t, 7)
    tok, ln, emb = (torch.from_numpy(x) for x in (tokens, lengths, embs))
    cache, first = te.prefill(tp, CFG512_T, tok, ln, t + 8, img_embs=emb, lora=tlora)
    assert len(calls) == flash_calls
    direct = tl.init_cache(CFG512_T, 3, t + 8, device="cpu")
    logits, direct = tl.llama_apply(
        tp, CFG512_T, tok, torch.arange(t)[None].repeat(3, 1), tl.prefill_bias(ln, t),
        cache=direct, img_embs=emb, img_start=tl.find_img_start(tok, 250), lora=tlora,
        lengths=ln, last_pos=ln - 1)
    if t < 256:
        for name in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(getattr(cache, name), getattr(direct, name)), name
        assert torch.equal(first, logits[:, 0])
    else:   # K3 and mha differ in f32 rounding only
        np.testing.assert_allclose(first.numpy(), logits[:, 0].numpy(), **LOGIT_TOL)


def test_prefill_at_256_plus_matches_jax_install_prefill():
    """The port's prefill (plain K3, then install_prefill) against JAX
    prefill(kv_int8=True) at batch 2 (JAX: mha on the CPU, then its
    install_prefill), FP32. The cache is held to one int8 step: a K/V value
    that lands on a rounding edge may round the other way after f32 sums
    in another order. Logits: LOGIT_TOL (module docstring). An activation
    on an int8 rounding edge in an early layer moves more than that: with
    the weights of seeds 1 and 5 at this shape the logits moved by up to
    0.09 and later layers' K by up to 7 steps (the same happens between
    JAX's own eager and jitted runs of one prefill, and between XLA
    optimization levels). These weights and inputs cross no edge in either
    of those JAX runs, so the bounds stay tight; test_torch_teacher_forced.py
    holds this path at seeds that do cross one."""
    from radialog_tpu.decode import engine as je
    from radialog_tpu_torch.decode import engine as te
    qp, lora, tp, tlora, _ = models(2)
    t, s_len = 272, 288
    tokens, lengths, embs = _prompt(2, t, 8)
    jcache, jfirst = je.prefill(qp, CFG512_J, jnp.asarray(tokens), jnp.asarray(lengths), s_len,
                                img_embs=jnp.asarray(embs), lora=lora, kv_int8=True)
    tcache, tfirst = te.prefill(tp, CFG512_T, torch.from_numpy(tokens),
                                torch.from_numpy(lengths), s_len, img_embs=torch.from_numpy(embs),
                                lora=tlora)
    np.testing.assert_allclose(tfirst.numpy(), np.asarray(jfirst), **LOGIT_TOL)
    for name in ("k", "v"):
        diff = np.abs(getattr(tcache, name).numpy().astype(np.int32)
                      - np.asarray(getattr(jcache, name)).astype(np.int32))
        assert diff.max() <= 1, name
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tcache, name).float().numpy(),
                                   np.asarray(getattr(jcache, name).astype(jnp.float32))[..., :4],
                                   rtol=1e-2, atol=0)


def test_prefix_kv_at_300_matches_jax():
    """prefix_kv of a 300-token prefix with the image in it: the port runs
    the plain K3 (t >= 256), JAX on the CPU its mha. FP32; K/V to 1e-4 as
    the shorter cache-free test above."""
    from radialog_tpu.decode import engine as je
    from radialog_tpu_torch.decode import engine as te
    qp, lora, tp, tlora, _ = models(4)
    tokens, _, embs = _prompt(1, 300, 9)
    jkv = je.prefix_kv(qp, CFG512_J, jnp.asarray(tokens[0]), lora=lora,
                       img_embs=jnp.asarray(embs))
    tkv = te.prefix_kv(tp, CFG512_T, torch.from_numpy(tokens[0]), lora=tlora,
                       img_embs=torch.from_numpy(embs))
    assert tkv.k.shape == (2, 300, 4, 16)
    np.testing.assert_allclose(tkv.k.numpy(), np.asarray(jkv.k), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tkv.v.numpy(), np.asarray(jkv.v), rtol=0, atol=1e-4)
