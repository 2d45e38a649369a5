"""Teacher-forced logits of the port's follow-up decode paths against the
JAX engine's, at every seed tried rather than at one chosen seed.

Greedy-text equality between the two (test_torch_eval.py,
test_torch_llama.py) holds only for weights with no activation on an int8
rounding edge near a greedy tie, so those tests name their seed. Here both
sides are fed the same forced ids, so a rounding edge that one side crosses
moves the logits without changing the tokens after it, and a bound that
admits such a crossing holds at any seed. Two shapes at TINY_LLAMA with
max_position 512, W8A8, int8 KV, FP32, weights through the bridge:

  follow_up  one 272-token prompt with the image and no shared prefix: the
             port prefills without a cache (plain K3), installs the K/V and
             decodes; JAX prefill(kv_int8=True) and its jitted decode step
  binary_qa  three lanes of 4-6 tokens after a 268-token shared prefix that
             holds the image: prefix prefill (plain K3 in the port), the
             remainder prefill over it, then decode over the int8 prefix
  correction one 160-token prompt with the image and no shared prefix, as
             the evaluation's batch-1 correction turn has it at the mock's
             size (below 256 tokens: the prefill without K3), decoded for
             48 steps so the cache fills well past the prompt (the whole
             256-step turns, on the prompts run_eval builds, at weight
             seeds 0-23: test_torch_eval_corrections.py)

The JAX decode takes its flash-decode kernel in Pallas interpret mode.

Bound: max |err| < 0.25 and mean |err| < 0.025 over all steps and lanes
(logit std ~1). Measured over seeds 0-13 of both shapes, half the seeds
agree to 1e-5 and the others cross an edge, by up to 0.122 (max) and
0.0178 (mean). Faults measured the same way: an install that leaves one
prompt row's K scale at 0 moves the logits by 4.5 (mean 0.87); a shared
prefix whose last row's K scale is 0 by 0.17-0.64 (mean 0.020-0.040), over
the bound at each of seeds 0-3. A K3 that drops the last valid key moves
them by 0.05-0.12 (mean 0.005-0.013), inside the noise: the exact tests at
their seeds and the K3 tests against JAX interpret catch that."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.decode import engine as je
from radialog_tpu.models import llama as jl
from radialog_tpu_torch.decode import engine as te
from radialog_tpu_torch.models import llama as tl

import test_torch_llama as tll

CJ, CT = tll.CFG512_J, tll.CFG512_T
NEW = 6
CORRECTION_NEW = 48
BOUND = {"max": 0.25, "mean": 0.025}


def _jax_prefix(qp, lora, prefix, embs, p0):
    """JAX shared-prefix K/V in the compute dtype, and its int8 copy per
    layer padded to 32 rows, as generate_shared_prefix(kv_int8=True) has them."""
    shared = je.prefix_kv(qp, CJ, jnp.asarray(prefix), lora=lora, img_embs=jnp.asarray(embs))
    L, _, H, D = shared.k.shape
    pad = ((0, 0), (0, -(-p0 // 32) * 32 - p0), (0, 0))
    k0, ks0 = jl.quantize_kv(shared.k)
    v0, vs0 = jl.quantize_kv(shared.v)
    k0, v0 = (jnp.pad(x.reshape(L, p0, H * D), pad) for x in (k0, v0))
    ks0, vs0 = (jnp.pad(jl.pad_scale_lanes(x), pad) for x in (ks0, vs0))
    return shared, tuple((k0[i], ks0[i], v0[i], vs0[i]) for i in range(L))


def _case(mode, seed):
    rng = np.random.default_rng(100 + seed)
    new = CORRECTION_NEW if mode == "correction" else NEW
    if mode in ("follow_up", "correction"):
        b, p0, t = 1, 0, 272 if mode == "follow_up" else 160
        tokens, lengths, embs = tll._prompt(1, t, 100 + seed)
    else:
        b, p0, t = 3, 268, 6
        prefix, _, embs = tll._prompt(1, p0, 100 + seed)
        prefix = prefix[0]
        tokens = rng.integers(3, 240, (b, t)).astype(np.int32)
        lengths = np.asarray([6, 5, 4], np.int32)
    forced = rng.integers(3, 240, (b, new)).astype(np.int32)
    cache_len = -(-(t + new) // 8) * 8 + 8
    return b, p0, t, tokens, lengths, embs, (prefix if p0 else None), forced, cache_len


def _jax_logits(qp, lora, b, p0, t, tokens, lengths, embs, prefix, forced, cache_len):
    lens = jnp.asarray(lengths)
    if p0 == 0:
        cache, first = je.prefill(qp, CJ, jnp.asarray(tokens), lens, cache_len,
                                  img_embs=jnp.asarray(embs), lora=lora, kv_int8=True)
        shared_c = None
    else:
        shared, shared_c = _jax_prefix(qp, lora, prefix, embs, p0)
        cache = jl.init_cache(CJ, b, cache_len, quantized=True)
        first, cache = jl.llama_apply(
            qp, CJ, jnp.asarray(tokens), p0 + jnp.arange(t)[None].repeat(b, 0),
            jl.prefill_bias(lens, t), cache=cache, write_pos=0, lora=lora, lengths=lens,
            last_pos=lens - 1, shared_kv=shared)
        first = first[:, 0]

    @jax.jit   # traced like the engine's decode loop body
    def step_fn(cache, tok, step):
        return jl.llama_apply(
            qp, CJ, tok[:, None], (lens + p0 + step)[:, None],
            jl.decode_bias_static_slot(lens, t, step, cache_len), cache=cache,
            write_pos=t + step, lora=lora, lengths=lens, slot_info=(t, step),
            shared_kv=shared_c, shared_p0=p0 if p0 else None)

    out = [np.asarray(first)]
    for step in range(forced.shape[1] - 1):
        lg, cache = step_fn(cache, jnp.asarray(forced[:, step]), jnp.asarray(step))
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, 1)


def _port_logits(tp, tlora, b, p0, t, tokens, lengths, embs, prefix, forced, cache_len):
    tok, lens, emb = (torch.from_numpy(x) for x in (tokens, lengths, embs))
    if p0 == 0:
        cache, first = te.prefill(tp, CT, tok, lens, cache_len, img_embs=emb, lora=tlora)
        kw = {}
    else:
        shared = te.prefix_kv(tp, CT, torch.from_numpy(prefix), lora=tlora, img_embs=emb)
        cache = tl.init_cache(CT, b, cache_len, device="cpu")
        first, cache = tl.llama_apply(
            tp, CT, tok, p0 + torch.arange(t)[None].repeat(b, 1), tl.prefill_bias(lens, t),
            cache=cache, lora=tlora, lengths=lens, last_pos=lens - 1, shared_kv=shared)
        first = first[:, 0]
        kw = dict(shared_kv=te.quantize_prefix(shared), pos_offset=p0, shared_p0=p0)
    out = [first.numpy()]
    for step in range(forced.shape[1] - 1):
        out.append(te.decode_step(tp, CT, cache, torch.from_numpy(forced[:, step]), lens, t,
                                  step, lora=tlora, **kw).numpy())
    return np.stack(out, 1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", ["follow_up", "binary_qa", "correction"])
def test_teacher_forced_logits_match_jax_at_any_seed(monkeypatch, mode, seed):
    monkeypatch.setenv("RADIALOG_FLASH_DECODE_FORCE", "interpret")
    qp, lora, tp, tlora, _ = tll.models(seed)
    case = _case(mode, seed)
    ref = _jax_logits(qp, lora, *case)
    got = _port_logits(tp, tlora, *case)
    assert got.shape == ref.shape == (case[0], case[-2].shape[1], CT.vocab_size)
    err = np.abs(got - ref)
    assert err.max() < BOUND["max"] and err.mean() < BOUND["mean"], (err.max(), err.mean())
