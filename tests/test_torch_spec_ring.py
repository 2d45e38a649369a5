"""Batched speculative decoding of the PyTorch port (decode/spec_ring.py
``SpecRingBatcher`` and ``SpecCompactBatcher``, and the pipeline's
``generate_texts_ring(spec_k=...)``) against the JAX package on the CPU,
TINY_LLAMA, W8A8 weights, FP32 policy, the same seeded weights and requests
as tests/test_torch_continuous.py (prompts of 3-30 tokens, every third with
an <IMG> run and its embeddings), staggered admission:

  * each session's tokens and the batcher's ``verifies`` equal JAX's. Over
    the bf16 cache the tokens also equal the port's plain ``RingBatcher``.
    Over the int8 cache the verify attention (int8 q.k, softmax, p
    requantized to int8, int8 p.v) is not the function of the plain ring's
    flash-decode kernel (K2), and greedy picks near a tie part (here one
    session at its 7th token); the tokens equal the JAX package's plain
    int8 ``RingBatcher`` run without the interpret-mode kernel, whose
    fallback is the verify's arithmetic (the JAX docstring's "token-identical
    on fp32 CPU for both caches"). The JAX compact batcher's int8 run is
    repeatable on the CPU (no interpret-mode kernel in its scanned step; run
    twice below), so it is driven as it is;
  * after one chunk of verifies and relocations: the int8 cache, every
    byte; the bf16 cache, each relocated row a byte copy of its window row
    on both sides, every row within one bf16 step of JAX's (two elements
    of 16,384 a layer differ: a prompt row the admission's prefill rounds
    apart and a verify row, copied to its frontier as it is); the validity
    mask, the histories and the host counters equal;
  * the refusals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.decode import continuous as jc
from radialog_tpu.decode import spec_ring as jsr
from radialog_tpu.decode.engine import DecodeParams as JDecodeParams
from radialog_tpu_torch.decode import continuous as tc
from radialog_tpu_torch.decode import spec_ring as tsr
from radialog_tpu_torch.decode.engine import DecodeParams

from test_torch_continuous import CJ, CT, SEED, _drive, _models, _requests

LANES, PROMPT, NEW, KS, CHUNK = 2, 32, 8, 3, 2
RING_CACHE, COMPACT_CACHE = 96, 64      # ring 64 = 16 windows of k+1; gen region 28


@pytest.fixture(scope="module")
def weights():
    return _models(SEED)


def _jax(cls, weights, cache_len, kv_int8=False, new=NEW):
    qp, lora, _, _ = weights
    return cls(qp, CJ, lanes=LANES, cache_len=cache_len, prompt_len=PROMPT,
               dp=JDecodeParams(max_new_tokens=new, eos_token_id=-1), lora=lora,
               steps_per_call=CHUNK, spec_k=KS, kv_int8=kv_int8)


def _port(cls, weights, cache_len, kv_int8=False, new=NEW, **kw):
    _, _, tp, tlora = weights
    return cls(tp, CT, lanes=LANES, cache_len=cache_len, prompt_len=PROMPT,
               dp=DecodeParams(max_new_tokens=new, eos_token_id=-1), lora=tlora,
               steps_per_call=CHUNK, kv_int8=kv_int8, device="cpu", **kw)


def _repeating():
    """Two prompts that repeat a phrase, whose drafts the model accepts (at
    generator seeds 9 and 10 the plain JAX and port rings already part at a
    rounding edge, before any speculation)."""
    rng = np.random.default_rng(11)
    return [(rng.integers(3, 240, n).tolist() * 4, None) for n in (4, 6)]


def _plain(weights, kv_int8):
    return _port(tc.RingBatcher, weights, RING_CACHE, kv_int8)


@pytest.mark.parametrize("cls,cache_len,kv_int8", [
    ("SpecRingBatcher", RING_CACHE, False),
    ("SpecCompactBatcher", COMPACT_CACHE, False),
    ("SpecCompactBatcher", COMPACT_CACHE, True)])
def test_tokens_and_verifies_match_jax_and_the_plain_ring(weights, cls, cache_len, kv_int8,
                                                         monkeypatch):
    monkeypatch.setenv("RADIALOG_FLASH_DECODE_FORCE", "interpret")
    reqs = _requests(SEED, 3) + _repeating()
    jb = _jax(getattr(jsr, cls), weights, cache_len, kv_int8)
    want = _drive(jb, reqs, jnp.asarray)
    tb = _port(getattr(tsr, cls), weights, cache_len, kv_int8, spec_k=KS)
    got = _drive(tb, reqs, torch.from_numpy)
    assert got == want
    assert all(len(t) == NEW for t in got)
    assert tb.verifies == jb.verifies > 0
    if not kv_int8:
        assert got == _drive(_plain(weights, kv_int8), reqs, torch.from_numpy)
        return
    qp, lora, _, _ = weights
    jplain = jc.RingBatcher(qp, CJ, lanes=LANES, cache_len=RING_CACHE, prompt_len=PROMPT,
                            dp=JDecodeParams(max_new_tokens=NEW, eos_token_id=-1), lora=lora,
                            steps_per_call=CHUNK, kv_int8=True)
    monkeypatch.delenv("RADIALOG_FLASH_DECODE_FORCE")
    assert got == _drive(jplain, reqs, jnp.asarray)
    assert _drive(_jax(getattr(jsr, cls), weights, cache_len, kv_int8), reqs,
                  jnp.asarray) == want      # the JAX compact int8 run repeats


@pytest.mark.parametrize("kv_int8", [False, True])
def test_compact_state_after_one_chunk_is_jax_bitwise(weights, kv_int8):
    """Two sessions admitted, one chunk of CHUNK verify + relocate rounds:
    every byte of the cache (the window's rows and the relocated frontier
    rows), the validity mask, the histories and the host counters equal."""
    reqs = _repeating()
    jb = _jax(jsr.SpecCompactBatcher, weights, COMPACT_CACHE, kv_int8)
    tb = _port(tsr.SpecCompactBatcher, weights, COMPACT_CACHE, kv_int8, spec_k=KS)
    for b, conv in ((jb, jnp.asarray), (tb, torch.from_numpy)):
        for ids, emb in reqs:
            b.submit(ids, img_embs=None if emb is None else conv(emb))
        b.step()
    names = ("k", "v", "k_scale", "v_scale") if kv_int8 else ("k", "v")
    valid = tb.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jb.valid))
    wb = COMPACT_CACHE - KS - 1
    for name in names:
        want = np.asarray(getattr(jb.cache, name).astype(jnp.float32))
        got = getattr(tb.cache, name).float().numpy()
        if name.endswith("scale"):
            want = want[..., :CT.num_heads]
        if kv_int8:
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0, err_msg=name)
        assert (got != want).sum() <= 2 * got.shape[0], name
        # the last verify's accepted rows: byte copies of the window's
        for lane in range(LANES):
            n_gen = int(valid[lane, PROMPT:wb].sum())
            for c in (got, want):
                last = c[:, lane, PROMPT + n_gen - 1]
                assert any(np.array_equal(last, c[:, lane, wb + j]) for j in range(KS + 1))
    np.testing.assert_array_equal(tb.hist.numpy(), np.asarray(jb.hist))
    for name in ("hist_lens", "cur_lens", "last_tok"):
        np.testing.assert_array_equal(getattr(tb, name), np.asarray(getattr(jb, name)))
    # accepted rows moved: each lane's frontier holds more rows than one a verify
    gen = tb.valid[:, PROMPT:tb.cache_len - KS - 1].sum(dim=1)
    assert int(gen.max()) > CHUNK


def test_refusals(weights):
    with pytest.raises(ValueError, match="SpecCompactBatcher"):
        _port(tsr.SpecRingBatcher, weights, RING_CACHE, kv_int8=True)
    with pytest.raises(ValueError, match="multiple of the verify window"):
        _port(tsr.SpecRingBatcher, weights, 90, spec_k=KS)
    with pytest.raises(ValueError, match="wrap onto live KV"):
        _port(tsr.SpecRingBatcher, weights, RING_CACHE, new=20, spec_k=KS)
    with pytest.raises(ValueError, match="generation region"):
        _port(tsr.SpecCompactBatcher, weights, COMPACT_CACHE, new=29, spec_k=KS)
    _, _, tp, tlora = weights
    for cls in (tsr.SpecRingBatcher, tsr.SpecCompactBatcher):
        with pytest.raises(ValueError, match="greedy"):
            cls(tp, CT, lanes=LANES, cache_len=RING_CACHE, prompt_len=PROMPT,
                dp=DecodeParams(max_new_tokens=4, do_sample=True), device="cpu")
    b = _port(tsr.SpecCompactBatcher, weights, COMPACT_CACHE, spec_k=KS)
    with pytest.raises(ValueError, match="generation region"):
        b.validate_request(10, 29)
    b.validate_request(10, 28)


def test_generate_texts_ring_with_spec_k_matches_jax():
    """The mock pipelines (W8A8, the int8 cache on both sides) with bridged
    weights: ``generate_texts_ring(spec_k=3)`` gives JAX's texts."""
    from test_torch_eval_harness import SEED as PSEED
    import jax
    from radialog_tpu.apps import pipeline as jpipe
    from radialog_tpu_torch import bridge
    from radialog_tpu_torch.apps.pipeline import PipelineConfig, RaDialogPipeline
    from test_torch_llama import packed_tree
    jp = jpipe.RaDialogPipeline(jpipe.PipelineConfig(mock=True, quantize=True, seed=PSEED))
    tp = RaDialogPipeline(PipelineConfig(mock=True, device="cpu", seed=PSEED))
    tp.llama = bridge.llama_serving(packed_tree(jp.llama), tp.llama_cfg, device="cpu")
    tp.lora = bridge.lora(jax.tree_util.tree_map(np.asarray, jp.lora), device="cpu")
    assert jp.cfg.use_kv_int8() and tp.cfg.use_kv_int8()
    rng = np.random.default_rng(0)
    prompts = [f"w{j} r{j} " + "<IMG> " * 32 + " ".join(f"t{j}x{i}" for i in range(2 + 9 * j))
               for j in range(3)]
    embs = rng.normal(size=(3, 32, tp.llama_cfg.qformer_dim)).astype(np.float32)
    want = jp.generate_texts_ring(prompts, max_new_tokens=10, lanes=2, img_embs=embs, spec_k=3)
    got = tp.generate_texts_ring(prompts, max_new_tokens=10, lanes=2,
                                 img_embs=torch.from_numpy(embs), spec_k=3)
    assert got == want
