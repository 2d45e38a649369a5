"""The port's quantization-budget tools (tools/measure_kv_logit_err_torch.py,
measure_quant_torch.py, measure_kv_int8_torch.py) against the same
measurements assembled here from the JAX package's functions (``generate``,
``prefill``, ``llama_apply``, ``quantize_llama_host``), as the JAX tools
make them, on the same float weights and tokens at a tiny width (hidden 64,
4 heads, FFN 128, vocab 256, 2 layers); then each tool's command line at
that width on the CPU, printing its twin's JSON keys.

The weights cross as numpy (the port's packs of them are bitwise JAX's,
tests/test_torch_llama.py); the JAX decode takes its flash-decode kernel in
Pallas interpret mode, the function K2 implements. The figures are
statistics of rounding noise, and the two packages round apart: their bf16
matmuls on the CPU sum in other orders, and at this width a last-bit change
crosses an int8 activation's rounding edge (logits up to 0.1 apart at
FP32). So each figure is held to JAX's as a statistic: the errors within
ERR_TOL (relative; measured apart by 3.2 % for the teacher-forced cache
error, 11.6 % for bf16's prefill error, 7.3 % for W8A8's, 0.1 % for
W4A8's), the agreements within AGREE_TOL (measured 0.008 teacher-forced,
0.113 / 0.031 / 0.004 for W8A8 / W4A8 asym / sym greedy, 0.047 for the
free-running cache). The teacher-forced runs are fed the same forced tokens
(JAX's jitted greedy continuation), and the statistics' formulas are
checked exactly on JAX's own tokens."""
import importlib.util
import json
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.decode import engine as je
from radialog_tpu.models import llama as jl
from radialog_tpu.ops.layers import BF16 as JBF16, FP32 as JFP32
from radialog_tpu.ops.quant import quantize_llama_host as jquantize
from radialog_tpu_torch import bridge
from radialog_tpu_torch.models.llama import LlamaConfig
from radialog_tpu_torch.ops.quant import quantize_llama_host

REPO = Path(__file__).resolve().parents[1]
WIDTH = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4,
             intermediate_size=128)
JCFG = jl.LlamaConfig(**WIDTH)
TCFG = LlamaConfig(**WIDTH)
ERR_TOL = 0.2
AGREE_TOL = 0.2
TINY_FLAGS = ["--device", "cpu", "--hidden", "64", "--heads", "4", "--ffn", "128",
              "--vocab", "256", "--layers", "2", "--seeds", "1"]


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights():
    host = jax.tree_util.tree_map(np.asarray, jl.llama_init(jax.random.PRNGKey(0), JCFG))
    return host, jquantize(host), quantize_llama_host(host, device="cpu")


def _prompts(seed, batch, t, vocab):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, vocab - 2, (batch, t)).astype(np.int32)
    lens = rng.integers(t // 2, t, batch).astype(np.int32)
    return toks, lens


@partial(jax.jit, static_argnames=("dp", "cache_len", "kv_int8", "policy"))
def _jax_generate(params, toks, lens, dp, cache_len, kv_int8=False, policy=JBF16):
    return je.generate(params, JCFG, toks, lens, dp, policy=policy, cache_len=cache_len,
                       kv_int8=kv_int8).tokens


@partial(jax.jit, static_argnames=("kv_int8", "t", "cache_len"))
def _jax_forced(params, toks, lens, forced, kv_int8, t, cache_len):
    """tools/measure_kv_logit_err.py's forced_logits."""
    cache, _ = je.prefill(params, JCFG, toks, lens, cache_len, policy=JBF16, kv_int8=kv_int8)

    def body(carry, tok):
        step, cache = carry
        bias = jl.decode_bias_static_slot(lens, t, step, cache_len)
        logits, cache = jl.llama_apply(params, JCFG, tok[:, None], (lens + step)[:, None], bias,
                                       cache=cache, write_pos=t + step, policy=JBF16,
                                       lengths=lens, slot_info=(t, step))
        return (step + 1, cache), logits[:, 0]
    _, rows = jax.lax.scan(body, (jnp.asarray(0), cache), forced.T)
    return rows.transpose(1, 0, 2)


def test_kv_logit_err_matches_jax(weights, monkeypatch):
    monkeypatch.setenv("RADIALOG_FLASH_DECODE_FORCE", "interpret")
    tool = _tool("measure_kv_logit_err_torch")
    _, jq, tq = weights
    t, steps, batch = 32, 16, 8
    cache_len = t + steps + 8
    toks, lens = _prompts(0, batch, t, JCFG.vocab_size)
    dp = je.DecodeParams(max_new_tokens=steps + 1, eos_token_id=-1)
    forced = np.asarray(_jax_generate(jq, jnp.asarray(toks), jnp.asarray(lens), dp,
                                      cache_len))[:, :steps]
    ref, got = (np.asarray(_jax_forced(jq, jnp.asarray(toks), jnp.asarray(lens),
                                       jnp.asarray(forced), kv, t, cache_len), np.float32)
                for kv in (False, True))
    want = np.abs(got - ref).mean(-1) / ref.std(axis=-1)
    want_agree = float((got.argmax(-1) == ref.argmax(-1)).mean())
    err, agree, used = tool.measure_seed(tq, TCFG, torch.from_numpy(toks),
                                         torch.from_numpy(lens), steps, cache_len,
                                         forced=torch.from_numpy(forced))
    np.testing.assert_array_equal(used, forced)
    assert err.shape == want.shape == (batch, steps)
    np.testing.assert_allclose(err.mean(), want.mean(), rtol=ERR_TOL)
    assert abs(agree - want_agree) <= AGREE_TOL


def test_quant_matches_jax(weights):
    tool = _tool("measure_quant_torch")
    host, _, _ = weights
    t, new, batch = 16, 16, 16
    cache_len = t + new + 14
    rng = np.random.default_rng(0)
    toks = rng.integers(3, JCFG.vocab_size - 1, (batch, t)).astype(np.int32)
    lens = np.full((batch,), t, np.int32)
    jt, jlens = jnp.asarray(toks), jnp.asarray(lens)
    positions = jnp.arange(t)[None].repeat(batch, 0)

    def last(p, policy):
        logits, _ = jl.llama_apply(p, JCFG, jt, positions, jl.prefill_bias(jlens, t),
                                   lengths=jlens, policy=policy, last_pos=jlens - 1)
        return np.asarray(logits[:, 0], np.float32)
    dp = je.DecodeParams(max_new_tokens=new, eos_token_id=-1)

    def greedy(p):
        return np.asarray(_jax_generate(p, jt, jlens, dp, cache_len))
    oracle = last(host, JFP32)
    scale = oracle.std()
    p16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), host)
    want = {"bf16": (np.abs(last(p16, JBF16) - oracle).mean() / scale, None)}
    ref = greedy(p16)
    modes = tool.modes_of("both")
    for name, bits, grid in modes:
        qp = jquantize(host, bits=bits, w4_mode=grid)
        want[name] = (np.abs(last(qp, JBF16) - oracle).mean() / scale,
                      float((greedy(qp) == ref).mean()))
    got = tool.measure_seed(bridge.llama(host, "cpu"), TCFG, torch.from_numpy(toks),
                            torch.from_numpy(lens), new, modes, cache_len)
    assert list(got) == ["bf16", "w8a8", "w4a8-asym", "w4a8-sym"]
    for name, (err, agree) in got.items():
        np.testing.assert_allclose(err, want[name][0], rtol=ERR_TOL, err_msg=name)
        if agree is not None:
            assert abs(agree - want[name][1]) <= AGREE_TOL, name


def test_kv_int8_matches_jax(weights, monkeypatch):
    monkeypatch.setenv("RADIALOG_FLASH_DECODE_FORCE", "interpret")
    tool = _tool("measure_kv_int8_torch")
    _, jq, tq = weights
    t, new, batch = 32, 16, 8
    cache_len = t + new + 14
    toks, lens = _prompts(1, batch, t, JCFG.vocab_size)
    dp = je.DecodeParams(max_new_tokens=new, eos_token_id=-1)
    ref, got = (np.asarray(_jax_generate(jq, jnp.asarray(toks), jnp.asarray(lens), dp,
                                         cache_len, kv)) for kv in (False, True))
    from radialog_tpu_torch.ops.layers import BF16
    pref, pgot = tool.measure_seed(tq, TCFG, torch.from_numpy(toks), torch.from_numpy(lens),
                                   new, cache_len, BF16)
    agree, first = tool.agreement(pref, pgot)
    wagree = (ref == got).mean(axis=1)
    assert abs(agree.mean() - wagree.mean()) <= AGREE_TOL
    # the tool's statistics of the JAX tokens are the JAX tool's
    jagree, jfirst = tool.agreement(ref, got)
    np.testing.assert_array_equal(jagree, wagree)
    for b in range(batch):
        d = np.nonzero(ref[b] != got[b])[0]
        assert jfirst[b] == (int(d[0]) if len(d) else new)


TWIN_KEYS = {
    "measure_kv_logit_err_torch": {"mode", "layers", "seeds", "batch", "prompt_len", "steps",
                                   "logit_err_per_sigma_mean", "logit_err_per_sigma_p95",
                                   "logit_err_last_step", "argmax_agreement_teacher_forced"},
    "measure_quant_torch": {"mode", "hidden", "heads", "layers", "seeds", "tokens", "batch",
                            "logit_err_vs_fp32"},
    "measure_kv_int8_torch": {"layers", "seeds", "batch", "prompt_len", "new_tokens",
                              "mean_agreement", "min_agreement", "p10_agreement",
                              "mean_first_divergence_step", "frac_fully_identical"},
}
SHORT = {"measure_kv_logit_err_torch": ["--prompt-len", "16", "--steps", "4"],
         "measure_quant_torch": ["--prompt-len", "16", "--tokens", "4", "--w4-mode", "both"],
         "measure_kv_int8_torch": ["--prompt-len", "16", "--new-tokens", "4",
                                   "--layers", "1,2"]}


@pytest.mark.parametrize("name", sorted(TWIN_KEYS))
def test_command_line(name, monkeypatch, capsys):
    tool = _tool(name)
    monkeypatch.setattr(sys, "argv", [name] + TINY_FLAGS + SHORT[name])
    tool.main()
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(rows) == {"measure_quant_torch": 4, "measure_kv_int8_torch": 2}.get(name, 1)
    for row in rows:
        assert TWIN_KEYS[name] <= set(row) and row["device"] == "cpu"
        assert "reference_points" not in row          # no figure of another device
        assert all(np.isfinite(v) for v in row.values() if isinstance(v, float))
