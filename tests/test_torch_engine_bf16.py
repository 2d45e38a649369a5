"""The batch engine's bf16 KV cache (``kv_int8=False``) of the PyTorch port
against the JAX engine, TINY_LLAMA W8A8 weights through the bridge, FP32
policy: ``prefill`` (direct into the cache on the serving layout),
``generate``, ``generate_shared_prefix`` (the decode reads a bf16 copy of
the prefix and merges it with the lane's rows in one softmax),
``decode_bias_static_slot`` and the pipeline's ``generate_texts``.

Tolerances: cache rows and logits within 1e-5 (f32 sums in another order;
the weight seed crosses no int8 rounding edge of an activation and no bf16
rounding of a cached K/V value in these runs), greedy tokens equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.apps.pipeline import PipelineConfig as JPipelineConfig
from radialog_tpu.apps.pipeline import RaDialogPipeline as JPipeline
from radialog_tpu.decode import engine as je
from radialog_tpu.models import llama as jl
from radialog_tpu_torch import bridge
from radialog_tpu_torch.apps.pipeline import PipelineConfig, RaDialogPipeline
from radialog_tpu_torch.decode import engine as te
from radialog_tpu_torch.models import llama as tl

import test_torch_llama as tll

TOL = dict(rtol=0, atol=1e-5)
B, T, NEW, SLEN, P0 = 3, 8, 6, 16, 6
# weights of seed 3 cross no int8 rounding edge and no bf16 cache rounding
# here; at seeds 2 and 4 a cached K/V value lands one bf16 step (4.9e-4) apart,
# and at seed 2 the batch-30 greedy tokens part after that
WEIGHT_SEED = 3


@pytest.fixture(scope="module")
def models():
    return tll.models(WEIGHT_SEED)


def _inputs():
    rng = np.random.default_rng(5)
    toks = rng.integers(3, 200, (B, T)).astype(np.int32)
    toks[:, 1:5] = jl.TINY_LLAMA.img_token_id
    lens = np.asarray([8, 6, 7], np.int32)
    img = rng.normal(size=(B, 4, 32)).astype(np.float32)
    forced = rng.integers(3, 200, (B, 3)).astype(np.int32)
    return toks, lens, img, forced


def _rows(c, name):
    x = getattr(c, name)
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def test_decode_bias_static_slot_matches_jax():
    lens = np.asarray([3, 9, 0, 12], np.int32)
    for pp, step in ((12, 0), (12, 5), (9, 0)):
        ref = np.asarray(jl.decode_bias_static_slot(jnp.asarray(lens), pp, step, 24))
        got = tl.decode_bias_static_slot(torch.from_numpy(lens), pp, step, 24)
        assert got.shape == (4, 1, 1, 24) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_prefill_and_decode_steps_match_jax(models):
    """The direct prefill into the bf16 cache, then three decode steps
    stepped by hand (the JAX step jitted as the engine's loop traces it)."""
    qp, lora, tp, tlora, _ = models
    toks, lens, img, forced = _inputs()
    jcache, jlast = je.prefill(qp, jl.TINY_LLAMA, jnp.asarray(toks), jnp.asarray(lens), SLEN,
                               img_embs=jnp.asarray(img), lora=lora, kv_int8=False)
    tcache, tlast = te.prefill(tp, tl.TINY_LLAMA, torch.from_numpy(toks),
                               torch.from_numpy(lens), SLEN, img_embs=torch.from_numpy(img),
                               lora=tlora, kv_int8=False)
    assert not tcache.quantized and tcache.k.dtype == torch.bfloat16
    assert tcache.k.shape == tuple(jcache.k.shape)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_rows(tcache, name), _rows(jcache, name), **TOL)
    jlens, tlens = jnp.asarray(lens), torch.from_numpy(lens)

    @jax.jit
    def jstep(cache, tok, step):
        return jl.llama_apply(qp, jl.TINY_LLAMA, tok[:, None], (jlens + step)[:, None],
                              jl.decode_bias_static_slot(jlens, T, step, SLEN), cache=cache,
                              write_pos=T + step, lora=lora, lengths=jlens,
                              slot_info=(T, step))

    for step in range(3):
        jlog, jcache = jstep(jcache, jnp.asarray(forced[:, step]), jnp.asarray(step))
        tlog = te.decode_step(tp, tl.TINY_LLAMA, tcache, torch.from_numpy(forced[:, step]),
                              tlens, T, step, lora=tlora)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog[:, 0]), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_rows(tcache, name), _rows(jcache, name), **TOL)


@pytest.mark.parametrize("batch", [B, 30])
def test_generate_matches_jax(models, batch):
    """Batch 3 and batch 30 (both prefill directly into the bf16 cache)."""
    qp, lora, tp, tlora, _ = models
    rng = np.random.default_rng(batch)
    toks = rng.integers(3, 200, (batch, T)).astype(np.int32)
    lens = rng.integers(4, T + 1, (batch,)).astype(np.int32)
    ref = je.generate_jit(qp, jl.TINY_LLAMA, jnp.asarray(toks), jnp.asarray(lens),
                          je.DecodeParams(max_new_tokens=NEW, eos_token_id=-1), lora=lora,
                          cache_len=SLEN, kv_int8=False)
    got = te.generate(tp, tl.TINY_LLAMA, torch.from_numpy(toks), torch.from_numpy(lens),
                      te.DecodeParams(max_new_tokens=NEW, eos_token_id=-1), lora=tlora,
                      cache_len=SLEN, kv_int8=False)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))


def test_generate_shared_prefix_matches_jax(models):
    """Greedy tokens of the whole call, then the per-step logits of the
    same computation stepped by hand over the bf16 prefix copy."""
    qp, lora, tp, tlora, _ = models
    toks, lens, img, forced = _inputs()
    prefix = np.random.default_rng(6).integers(3, 200, (P0,)).astype(np.int32)
    dp_j = je.DecodeParams(max_new_tokens=NEW, eos_token_id=-1)
    dp_t = te.DecodeParams(max_new_tokens=NEW, eos_token_id=-1)
    ref = je.generate_shared_jit(qp, jl.TINY_LLAMA, jnp.asarray(prefix), jnp.asarray(toks),
                                 jnp.asarray(lens), dp_j, img_embs=jnp.asarray(img), lora=lora,
                                 cache_len=SLEN, kv_int8=False)
    got = te.generate_shared_prefix(tp, tl.TINY_LLAMA, torch.from_numpy(prefix),
                                    torch.from_numpy(toks), torch.from_numpy(lens), dp_t,
                                    img_embs=torch.from_numpy(img), lora=tlora, cache_len=SLEN,
                                    kv_int8=False)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))

    jshared = je.prefix_kv(qp, jl.TINY_LLAMA, jnp.asarray(prefix), lora=lora)
    tshared = te.prefix_kv(tp, tl.TINY_LLAMA, torch.from_numpy(prefix), lora=tlora)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1)) + P0
    jlens, tlens = jnp.asarray(lens), torch.from_numpy(lens)
    jlog, jcache = jl.llama_apply(
        qp, jl.TINY_LLAMA, jnp.asarray(toks), jnp.asarray(pos), jl.prefill_bias(jlens, T),
        cache=jl.init_cache(jl.TINY_LLAMA, B, SLEN), write_pos=0, img_embs=jnp.asarray(img),
        img_start=jl.find_img_start(jnp.asarray(toks), jl.TINY_LLAMA.img_token_id), lora=lora,
        lengths=jlens, last_pos=jlens - 1, shared_kv=jshared)
    tlog, tcache = tl.llama_apply(
        tp, tl.TINY_LLAMA, torch.from_numpy(toks), torch.from_numpy(pos),
        tl.prefill_bias(tlens, T), cache=tl.init_cache(tl.TINY_LLAMA, B, SLEN, device="cpu",
                                                       quantized=False),
        img_embs=torch.from_numpy(img),
        img_start=tl.find_img_start(torch.from_numpy(toks), tl.TINY_LLAMA.img_token_id),
        lora=tlora, lengths=tlens, last_pos=tlens - 1, shared_kv=tshared)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    jc = tuple((jshared.k[i].astype(jnp.bfloat16), jshared.v[i].astype(jnp.bfloat16))
               for i in range(jshared.k.shape[0]))
    tc = [(tshared.k[i].to(torch.bfloat16), tshared.v[i].to(torch.bfloat16))
          for i in range(tshared.k.shape[0])]

    @jax.jit
    def jstep(cache, tok, step):
        return jl.llama_apply(qp, jl.TINY_LLAMA, tok[:, None], (jlens + P0 + step)[:, None],
                              jl.decode_bias_static_slot(jlens, T, step, SLEN), cache=cache,
                              write_pos=T + step, lora=lora, lengths=jlens,
                              slot_info=(T, step), shared_kv=jc, shared_p0=P0)

    for step in range(3):
        jlog, jcache = jstep(jcache, jnp.asarray(forced[:, step]), jnp.asarray(step))
        tlog = te.decode_step(tp, tl.TINY_LLAMA, tcache, torch.from_numpy(forced[:, step]),
                              tlens, T, step, lora=tlora, shared_kv=tc, pos_offset=P0,
                              shared_p0=P0)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog[:, 0]), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_rows(tcache, name), _rows(jcache, name), **TOL)


@pytest.fixture(scope="module")
def pipelines():
    """The JAX mock pipeline (W8A8, bf16 KV) and the port's mock with the
    JAX LLaMA and LoRA weights through the bridge."""
    jp = JPipeline(JPipelineConfig(mock=True, quantize=True, kv_int8=False, seed=0,
                                   max_new_tokens=8))
    tp = RaDialogPipeline(PipelineConfig(mock=True, device="cpu", seed=0, kv_int8=False,
                                         max_new_tokens=8))
    tp.llama = bridge.llama_serving(tll.packed_tree(jp.llama), tp.llama_cfg, device="cpu")
    tp.lora = bridge.lora(jax.tree_util.tree_map(np.asarray, jp.lora), device="cpu")
    return jp, tp


def test_pipeline_generate_texts_matches_jax(pipelines):
    """A report batch with a 24-token shared prefix and one image each, and
    two prompts that share nothing (seed 0 of the mock has no near tie in
    these runs)."""
    jp, tp = pipelines
    shared = " ".join(f"sys{i}" for i in range(23))
    prompts = [f"{shared} r{j} a{j} " + "<IMG> " * 32 + f"t{j} u{j}" for j in range(3)]
    embs = np.random.default_rng(1).normal(size=(3, 32, 32)).astype(np.float32)
    assert tp._shared_prefix_len([tp.tokenizer(p)["input_ids"] for p in prompts],
                                 torch.from_numpy(embs))[0] >= 16
    ref = jp.generate_texts(prompts, img_embs=jnp.asarray(embs))
    got = tp.generate_texts(prompts, img_embs=torch.from_numpy(embs))
    assert got == ref
    plain = ["alpha beta gamma", "delta " * 9 + "epsilon"]
    assert tp.generate_texts(plain) == jp.generate_texts(plain)


def test_pipeline_sampling_and_beams(pipelines):
    _, tp = pipelines
    prompts = ["a b c d e", "f g h"]
    first = tp.generate_texts(prompts, do_sample=True, temperature=0.9)
    again = tp.generate_texts(prompts, do_sample=True, temperature=0.9)
    assert first == again and all(t.startswith(p) for t, p in zip(first, prompts))
    dp = tp.decode_params(do_sample=True, temperature=0.9)
    assert dp.do_sample and dp.temperature == 0.9 and dp.seed == tp.cfg.seed
    with pytest.raises(NotImplementedError, match="beam"):
        tp.generate_texts(prompts, num_beams=2)
