"""RaDialogServer of the PyTorch port: the thread-safe front end over the
ring batcher, on the CPU at TINY_LLAMA (W8A8, FP32 policy), and
``generate_texts_ring`` on the mock pipeline. One case holds the server
against the JAX package's on the same weights (bf16 ring: the JAX int8 ring
step is no stable reference on the CPU, tests/test_torch_continuous.py).

A session's tokens do not depend on which lane or ring position it got, up
to the order of f32 sums over the cache slots; the cases that compare
against a serial run use weights and prompts where no greedy tie is that
close (seed 0), as the JAX package's own serving tests do."""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.apps.serve import RaDialogServer as JServer
from radialog_tpu.decode.engine import DecodeParams as JDecodeParams
from radialog_tpu.models import llama as jl
from radialog_tpu.ops.quant import quantize_llama_host as jquantize
from radialog_tpu_torch import bridge
from radialog_tpu_torch.apps.pipeline import PipelineConfig, RaDialogPipeline
from radialog_tpu_torch.apps.serve import RaDialogServer
from radialog_tpu_torch.decode.continuous import RingBatcher
from radialog_tpu_torch.decode.engine import DecodeParams
from radialog_tpu_torch.models import llama as tl
from radialog_tpu_torch.ops.quant import quantize_llama_host

from test_torch_llama import packed_tree

CFG = tl.TINY_LLAMA
TIMEOUT = 120


@pytest.fixture(scope="module")
def params():
    gen = torch.Generator().manual_seed(0)
    return quantize_llama_host(tl.llama_init(gen, CFG, device="cpu"), device="cpu")


def _prompt(n, seed):
    return [int(x) for x in np.random.default_rng(seed).integers(3, 200, n)]


def _server(params, kv_int8=True, lanes=2, max_new=6, steps_per_call=2, eos=-1):
    return RaDialogServer(params, CFG, lanes=lanes, cache_len=96, prompt_len=32,
                          dp=DecodeParams(max_new_tokens=max_new, eos_token_id=eos),
                          steps_per_call=steps_per_call, kv_int8=kv_int8, device="cpu")


def _serial(params, prompt, kv_int8=True, max_new=6):
    rb = RingBatcher(params, CFG, lanes=1, cache_len=96, prompt_len=32,
                     dp=DecodeParams(max_new_tokens=max_new, eos_token_id=-1),
                     kv_int8=kv_int8, device="cpu")
    sid = rb.submit(prompt)
    return rb.run()[sid].tokens


@pytest.mark.parametrize("kv_int8", [True, False])
def test_concurrent_clients_match_serial(params, kv_int8):
    """More client threads than lanes and than cores, a shortened switch
    interval: every future resolves with its own session's tokens, and the
    server drains cleanly on shutdown."""
    srv = _server(params, kv_int8)
    prompts = [_prompt(4 + i, 70 + i) for i in range(10)]
    results = [None] * len(prompts)

    def client(i):
        results[i] = srv.generate(prompts[i], timeout=TIMEOUT)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    srv.shutdown()
    assert not srv._thread.is_alive() and not srv._futures and not srv._rb.finished
    for i, prompt in enumerate(prompts):
        assert results[i] == _serial(params, prompt, kv_int8), i


def test_bad_request_fails_its_future_only(params):
    srv = _server(params, lanes=1, max_new=4)
    bad = srv.submit(_prompt(40, 80))                  # buckets to 64 > prompt region
    too_long = srv.submit(_prompt(5, 82), max_new_tokens=80)    # does not fit the ring
    good = srv.submit(_prompt(5, 81))
    with pytest.raises(ValueError, match="prompt region"):
        bad.result(timeout=TIMEOUT)
    with pytest.raises(ValueError, match="ring"):
        too_long.result(timeout=TIMEOUT)
    assert good.result(timeout=TIMEOUT) == _serial(params, _prompt(5, 81), max_new=4)
    assert not srv._rb.finished                        # resolved sessions are released
    srv.shutdown()


def test_streaming_deltas_concat_to_result(params):
    srv = _server(params)
    events = []
    fut = srv.submit(_prompt(5, 70), on_tokens=lambda d, done: events.append((d, done)))
    other = srv.submit(_prompt(7, 71))                 # a neighbour that does not stream
    result = fut.result(timeout=TIMEOUT)
    other.result(timeout=TIMEOUT)
    srv.shutdown()
    assert [t for d, _ in events for t in d] == result and len(result) == 6
    assert sum(done for _, done in events) == 1 and events[-1][1] is True
    assert len(events) >= max(1, (len(result) - 1) // 2)   # chunked deliveries


def test_raising_stream_callback_still_gets_final_done(params):
    srv = _server(params, lanes=1)
    events = []

    def cb(delta, done):
        events.append((list(delta), done))
        if len(events) == 1:
            raise RuntimeError("transient consumer failure")

    result = srv.submit(_prompt(5, 95), on_tokens=cb).result(timeout=TIMEOUT)
    srv.shutdown()
    assert len(result) == 6                            # the future is unaffected
    assert events[-1] == ([], True) and len(events) == 2   # dropped after the failure


def test_submit_after_shutdown_raises(params):
    srv = _server(params, lanes=1)
    srv.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        srv.submit(_prompt(4, 90))
    with pytest.raises(ValueError):
        RaDialogServer(params, CFG, batcher=srv._rb)
    with pytest.raises(ValueError):
        RaDialogServer(params)


def test_warmup_then_serves(params):
    srv = _server(params)
    try:
        assert srv.warmup(prompt_buckets=(32,), timeout=TIMEOUT) > 0
        assert srv._rb.active_lanes == 0
        prompt = _prompt(7, 0)
        assert srv.generate(prompt, timeout=TIMEOUT) == _serial(params, prompt)
    finally:
        srv.shutdown()


def test_fatal_step_error_fails_every_outstanding_future(params):
    """An error inside the shared decode step reaches every future in
    flight and the streams' final call, and the server refuses new work."""
    srv = _server(params, max_new=30, steps_per_call=1)
    calls = {"n": 0}
    step = srv._rb._step_fn

    def failing(*args):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("device fault")
        return step(*args)
    srv._rb._step_fn = failing
    events = []
    futs = [srv.submit(_prompt(5, 60 + i), on_tokens=lambda d, done: events.append(done))
            for i in range(3)]                         # two in lanes, one queued
    for f in futs:
        with pytest.raises(RuntimeError, match="device fault"):
            f.result(timeout=TIMEOUT)
    srv._thread.join(timeout=TIMEOUT)
    assert not srv._thread.is_alive() and events.count(True) >= 2
    with pytest.raises(RuntimeError, match="died"):
        srv.submit(_prompt(4, 1))


def test_server_matches_jax_server_bf16_ring():
    """The same W8A8 weights (through the bridge), the same prompts with
    one image: the port's server and the JAX package's give the same ids."""
    host = jax.tree_util.tree_map(np.asarray, jl.llama_init(jax.random.PRNGKey(0), jl.TINY_LLAMA))
    qp = jquantize(host)
    tp = bridge.llama_serving(packed_tree(qp), CFG, device="cpu")
    lora = jl.lora_init(jax.random.PRNGKey(1), jl.TINY_LLAMA)     # holds img_proj
    tlora = bridge.lora(jax.tree_util.tree_map(np.asarray, lora), device="cpu")
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(1, CFG.num_img_tokens, CFG.qformer_dim)).astype(np.float32)
    prompts = [_prompt(4 + 3 * i, 40 + i) for i in range(4)]
    prompts[1] = prompts[1][:2] + [CFG.img_token_id] * CFG.num_img_tokens + prompts[1][2:]
    embs = [None, emb, None, None]
    kw = dict(lanes=2, cache_len=96, prompt_len=32, steps_per_call=2)
    jsrv = JServer(qp, jl.TINY_LLAMA, dp=JDecodeParams(max_new_tokens=6, eos_token_id=-1),
                   lora=lora, **kw)
    tsrv = RaDialogServer(tp, CFG, dp=DecodeParams(max_new_tokens=6, eos_token_id=-1),
                          lora=tlora, device="cpu", **kw)
    try:
        jf = [jsrv.submit(p, img_embs=None if e is None else jnp.asarray(e))
              for p, e in zip(prompts, embs)]
        tf = [tsrv.submit(p, img_embs=None if e is None else torch.from_numpy(e))
              for p, e in zip(prompts, embs)]
        want = [f.result(timeout=300) for f in jf]
        got = [f.result(timeout=TIMEOUT) for f in tf]
    finally:
        jsrv.shutdown()
        tsrv.shutdown()
    assert got == want and all(len(t) == 6 for t in got)


@pytest.mark.parametrize("bits", [8, 4])
def test_generate_texts_ring_equals_generate_texts(bits):
    p = RaDialogPipeline(PipelineConfig(mock=True, device="cpu", max_new_tokens=7,
                                        weight_bits=bits, shared_prefix=False))
    embs = p.embed_images(torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(1)))
    prompts = [f"w{j} r{j} " + "<IMG> " * 32 + " ".join(f"t{j}x{i}" for i in range(2 + 9 * j))
               for j in range(4)]
    want = p.generate_texts(prompts, img_embs=embs)
    got = p.generate_texts_ring(prompts, lanes=3, steps_per_call=4, img_embs=embs)
    assert got == want
    assert p.generate_texts_ring(prompts[:2], max_new_tokens=3, lanes=12, steps_per_call=1) == \
        p.generate_texts(prompts[:2], max_new_tokens=3)


def test_pipeline_config_checks_and_the_bf16_ring():
    with pytest.raises(ValueError, match="weight_bits"):
        PipelineConfig(mock=True, weight_bits=5)
    assert PipelineConfig().use_kv_int8() and PipelineConfig(kv_int8=True).use_kv_int8()
    p = RaDialogPipeline(PipelineConfig(mock=True, device="cpu", max_new_tokens=5,
                                        kv_int8=False))
    prompts = ["a b c d", "e f " + "g " * 20]
    with pytest.raises(NotImplementedError, match="bf16"):
        p.generate_texts(prompts)
    with pytest.raises(NotImplementedError, match="spec_ring"):
        p.generate_texts_ring(prompts, spec_k=3)
    texts = p.generate_texts_ring(prompts, lanes=2)
    assert [t.startswith(q) and len(t) > len(q) for t, q in zip(texts, prompts)] == [True] * 2
