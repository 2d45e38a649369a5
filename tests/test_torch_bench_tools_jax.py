"""What each serving bench tool of the port times, against the JAX engine
call its original times, at TINY_LLAMA on weights carried across by the
bridge (W8A8 from the JAX ``quantize_llama_host``, LoRA with random b), FP32
policy, EOS off. Tokens must be equal:

  * tools/bench_torch.py ``report_step`` and tools/bench_sweep_torch.py
    ``sweep_step`` (``--shared-prefix --kv-int8 --unroll 3``), given the
    same query embeddings, against JAX's ``generate_shared_jit`` over the
    int8 cache (one JAX run for both; its flash-decode in Pallas interpret
    mode, RADIALOG_FLASH_DECODE_FORCE=interpret, as the other tests);
  * tools/bench_qa_pass_torch.py's plain and shared passes
    (``--no-kv-int8``: the bf16 cache) against JAX's ``generate_jit`` and
    ``generate_shared_jit`` (the image in the prefix);
  * tools/bench_interactive_torch.py's protocol (``drive``) over the port's
    ``RingBatcher`` and over JAX's, bf16 ring, every session's tokens;
  * tools/bench_spec_torch.py's plain loop and ``generate_spec`` with the
    oracle drafter against JAX's ``generate_jit`` and ``generate_spec_jit``
    with the JAX tool's oracle; the oracle accepts every draft on both sides
    (k + 1 tokens a verify);
  * tools/bench_chat_torch.py's session turns (``run_session``) over the
    port's ``InteractiveSession`` and over JAX's;
  * tools/bench_warmup_torch.py's warm-up (``warm``: a 128-token turn and
    its reply, then a reset) followed by its first turn (``first_turn``:
    120 ids and a reply) against JAX's ``InteractiveSession.warmup`` with
    the JAX tool's arguments followed by the same turn. TINY_LLAMA's 128
    positions are widened to 512 on both sides (the warm-up turn alone
    fills 128).

The JAX side is jitted. SEED crosses no int8 rounding edge near a greedy tie
in these runs (ROADMAP.md section 3: JAX's own eager and jitted W8A8 runs
part at such edges).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.decode import continuous as jc
from radialog_tpu.decode import engine as je
from radialog_tpu.decode.session import InteractiveSession as JSession
from radialog_tpu.decode.speculative import generate_spec_jit
from radialog_tpu.models import llama as jl
from radialog_tpu.ops.quant import quantize_llama_host
from radialog_tpu_torch import bridge
from radialog_tpu_torch.decode.session import InteractiveSession
from tools import (bench_chat_torch, bench_interactive_torch, bench_qa_pass_torch,
                   bench_spec_torch, bench_sweep_torch, bench_torch, bench_warmup_torch)

import test_torch_llama as tll

SEED = 0
CFG = jl.TINY_LLAMA
MODEL = bench_torch.Model(llama=CFG, bf16=False)


@pytest.fixture(scope="module")
def weights():
    """(JAX serving params, JAX LoRA, the port's tool models)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(SEED))
    qp = quantize_llama_host(jax.tree_util.tree_map(np.asarray, jl.llama_init(k1, CFG)))
    lora = jl.lora_init(k2, CFG)
    rng = np.random.default_rng(SEED)
    for t in lora["layers"]:
        lora["layers"][t]["b"] = jnp.asarray(
            rng.normal(size=lora["layers"][t]["b"].shape).astype(np.float32) * 0.1)
    models = {"params": bridge.llama_serving(tll.packed_tree(qp), CFG, device="cpu"),
              "lora": bridge.lora(jax.tree_util.tree_map(np.asarray, lora), device="cpu")}
    return qp, lora, models


@pytest.fixture(scope="module")
def interpret():
    mp = pytest.MonkeyPatch()
    mp.setenv("RADIALOG_FLASH_DECODE_FORCE", "interpret")    # before the first trace
    yield
    mp.undo()


def _args(module, argv):
    return module.build_parser().parse_args([*argv, "--device", "cpu"])


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


# --------------------------------------------- bench and sweep: shared prefix
SHAPE = bench_torch.Shape(batch=2, prompt_len=16, shared_prefix=6, new_tokens=6,
                          lane_cache=32, runs=1)
SWEEP = ["--batch", "2", "--prompt-len", "16", "--shared-prefix", "6", "--cache-len", "38",
         "--new-tokens", "6", "--kv-int8", "--unroll", "3"]


@pytest.fixture(scope="module")
def report(weights, interpret):
    """The report pass's inputs, query embeddings and JAX's tokens."""
    qp, lora, _ = weights
    inputs = bench_torch.report_inputs(MODEL, SHAPE, "cpu")
    embs = np.random.default_rng(1).normal(
        size=(SHAPE.batch, CFG.num_img_tokens, CFG.qformer_dim)).astype(np.float32)
    dp = je.DecodeParams(max_new_tokens=SHAPE.new_tokens, eos_token_id=-1, unroll=3)
    res = je.generate_shared_jit(qp, CFG, jnp.asarray(_np(inputs["prefix"])),
                                 jnp.asarray(_np(inputs["tokens"])),
                                 jnp.asarray(_np(inputs["lengths"])), dp,
                                 img_embs=jnp.asarray(embs), lora=lora,
                                 cache_len=SHAPE.lane_cache, kv_int8=True)
    return inputs, torch.from_numpy(embs), np.asarray(res.tokens)


@pytest.mark.parametrize("tool", ["bench", "sweep"])
def test_report_pass_matches_jax_generate_shared_prefix(weights, report, tool):
    _, _, models = weights
    inputs, embs, want = report
    if tool == "bench":
        got = bench_torch.report_step(models, MODEL, SHAPE, inputs, embs=embs)
    else:
        args = _args(bench_sweep_torch, SWEEP)
        sweep_in = bench_sweep_torch.sweep_inputs(args, MODEL, "cpu")
        for k in ("prefix", "tokens", "lengths"):       # the two tools draw alike
            assert torch.equal(sweep_in[k], inputs[k])
        got = bench_sweep_torch.sweep_step(args, models, MODEL, sweep_in, embs=embs)
    assert want.shape == (SHAPE.batch, SHAPE.new_tokens)
    np.testing.assert_array_equal(got.tokens.numpy(), want)


# ---------------------------------------------------------------- binary QA
def test_qa_passes_match_jax(weights):
    qp, lora, models = weights
    args = _args(bench_qa_pass_torch, ["--hist-len", "24", "--q-len", "6", "--new-tokens", "4",
                                       "--batch", "3", "--no-kv-int8"])
    inputs = bench_qa_pass_torch.qa_inputs(args, CFG, "cpu")
    got = {k: fn().tokens.numpy() for k, fn in
           bench_qa_pass_torch.qa_passes(args, models, MODEL, inputs, "cpu").items()}
    b, h, q, new = args.batch, args.hist_len, args.q_len, args.new_tokens
    dp = je.DecodeParams(max_new_tokens=new, eos_token_id=-1)
    emb1 = jnp.asarray(_np(inputs["emb1"]))
    full = np.concatenate([np.tile(inputs["hist"][None], (b, 1)), inputs["qs"]], axis=1)
    plain = je.generate_jit(qp, CFG, jnp.asarray(full), jnp.full((b,), h + q, jnp.int32), dp,
                            img_embs=jnp.tile(emb1, (b, 1, 1)), lora=lora,
                            cache_len=-(-(h + q + new) // 32) * 32)
    shared = je.generate_shared_jit(qp, CFG, jnp.asarray(inputs["hist"]),
                                    jnp.asarray(inputs["qs"]), jnp.full((b,), q, jnp.int32), dp,
                                    prefix_img_embs=emb1, lora=lora,
                                    cache_len=-(-(q + new) // 32) * 32)
    np.testing.assert_array_equal(got["plain"], np.asarray(plain.tokens))
    np.testing.assert_array_equal(got["shared"], np.asarray(shared.tokens))


# ------------------------------------------------------------ the ring batcher
def test_interactive_protocol_matches_jax_ring(weights):
    qp, _, models = weights
    args = _args(bench_interactive_torch, ["--lanes", "2", "--cache-len", "64", "--prompt-len",
                                           "12", "--new-tokens", "6", "--sessions", "3",
                                           "--steps-per-call", "2"])
    with torch.no_grad():
        got = bench_interactive_torch.drive(
            bench_interactive_torch.make_batcher(args, models["params"], MODEL, "cpu"),
            args, CFG)
    jrb = jc.RingBatcher(qp, CFG, lanes=args.lanes, cache_len=args.cache_len, prompt_len=32,
                         dp=je.DecodeParams(max_new_tokens=args.new_tokens, eos_token_id=-1),
                         steps_per_call=args.steps_per_call)
    want = bench_interactive_torch.drive(jrb, args, CFG)
    assert len(got["tokens"]) == args.sessions + 2
    assert got["tokens"] == want["tokens"]
    assert got["total_tokens"] == want["total_tokens"] == args.sessions * args.new_tokens


# ------------------------------------------------------------- speculation
def test_spec_plain_and_oracle_match_jax(weights):
    qp, lora, models = weights
    args = _args(bench_spec_torch, ["--prompt-len", "20", "--new-tokens", "13"])
    tokens, plain, spec = bench_spec_torch.spec_calls(args, models, MODEL, "cpu")
    got_plain = plain()
    stream = got_plain.tokens[0].numpy().astype(np.int32)
    (mode, oracle), *_ = bench_spec_torch.drafters(stream, args, args.prompt_len, "cpu")
    assert mode == "oracle"
    got = spec(oracle)
    t, k = args.prompt_len, args.k
    dp = je.DecodeParams(max_new_tokens=args.new_tokens, eos_token_id=-1)
    cache_len = -(-(t + args.new_tokens + k + 1) // 128) * 128
    jtok = jnp.asarray(tokens.numpy())
    want_plain = je.generate_jit(qp, CFG, jtok, jnp.full((1,), t, jnp.int32), dp, lora=lora,
                                 cache_len=cache_len)
    tbl = jnp.concatenate([jnp.asarray(np.asarray(want_plain.tokens)[0]),
                           jnp.zeros((k,), jnp.int32)])

    def jax_oracle(hist, hist_len):          # the JAX tool's oracle drafter
        return jax.lax.dynamic_slice(tbl, (hist_len - t,), (k,))
    want = generate_spec_jit(qp, CFG, jtok, dp, k=k, m=args.m, lora=lora, cache_len=cache_len,
                             proposer=jax_oracle)
    np.testing.assert_array_equal(got_plain.tokens.numpy(), np.asarray(want_plain.tokens))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.tokens.numpy(), got_plain.tokens.numpy())
    every_draft = -(-(args.new_tokens - 1) // (k + 1))
    assert got.iters == int(want.iters) == every_draft


# ---------------------------------------------------------------- the chat
def test_chat_session_turns_match_jax(weights):
    qp, lora, models = weights
    args = _args(bench_chat_torch, ["--turns", "1", "--prompt-len", "12", "--turn-len", "6",
                                    "--report-tokens", "5", "--reply-tokens", "4",
                                    "--cache-len", "64"])
    with torch.no_grad():
        _, got = bench_chat_torch.run_session(
            InteractiveSession(models["params"], CFG, lora=models["lora"], cache_len=64,
                               device="cpu"),
            bench_chat_torch.conversation(args, CFG), args, spec=False, convs=1)
    _, want = bench_chat_torch.run_session(
        JSession(qp, CFG, lora=lora, cache_len=64),
        bench_chat_torch.conversation(args, CFG, je.DecodeParams), args, spec=False, convs=1)
    assert [len(r) for r in got[0]] == [5, 4]
    assert got == want


# ------------------------------------------------------------- the warm-up
def test_warmup_then_first_turn_matches_jax(weights):
    qp, lora, models = weights
    cfg = dataclasses.replace(CFG, max_position=512)
    args = _args(bench_warmup_torch, ["--max-new", "6", "--cache-len", "288"])
    sess = InteractiveSession(models["params"], cfg, lora=models["lora"],
                              cache_len=args.cache_len, device="cpu")
    bench_warmup_torch.warm(sess, args)
    assert sess.cur_len == 0 and sess.token_ids == []
    got = bench_warmup_torch.first_turn(sess, args, cfg)
    jsess = JSession(qp, cfg, lora=lora, cache_len=args.cache_len)
    dp = je.DecodeParams(max_new_tokens=args.max_new, eos_token_id=-1)
    jsess.warmup(dp, turn_lengths=(128,), spec_k=0)        # the JAX tool's call
    assert jsess.cur_len == 0 and jsess.token_ids == []
    ids = np.random.default_rng(0).integers(3, min(30000, cfg.vocab_size), 120)
    jsess.append_tokens([int(x) for x in ids])
    want = jsess.generate(dp)
    assert len(got) == args.max_new
    assert got == [int(x) for x in want]
