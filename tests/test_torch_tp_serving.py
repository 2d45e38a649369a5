"""Tensor-parallel serving of the port (radialog_tpu_torch/parallel/
tp_serving.py, core/mesh.py, the ``tp_group`` sum through llama_apply, the
engine and beam search) against the JAX package's (radialog_tpu/parallel/
tp_serving.py on the conftest's 8-device CPU mesh).

One group of two gloo rank processes (tests/torch_tp_ranks.py, meeting
through the RADIALOG_* environment) runs every sharded case of this module
on TINY_LLAMA: TP = 1 on a (data 2, model 1) mesh, TP = 2 on (1, 2), over
the int8 cache with LoRA and images, the bf16 cache, a shared prefix, two
beams and W4A8. JAX runs its ``make_tp_generate`` on (data 4, model 2) for
TP = 2. FP32 policy, as the JAX package's own TP tests.

Tolerances: none. The packs of each rank are bitwise JAX's per-shard
leaves; TP = 1 tokens equal the port's unsharded ``generate``,
``generate_shared_prefix`` and ``generate_beam``; TP = 2 tokens equal
JAX's in every case, W4A8 included (its groups restarting at the shard
boundary on both sides), with JAX's flash-decode kernel in Pallas interpret
mode. (JAX's default CPU fallback for the int8 decode attention quantizes
the softmax weights, another function than K2: against it 3 of 8 rows part
at a near-tie.)"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from radialog_tpu.core.mesh import MeshSpec as JMeshSpec, make_mesh as jmake_mesh
from radialog_tpu.decode.engine import DecodeParams as JDecodeParams
from radialog_tpu.models.llama import TINY_LLAMA as JTINY, llama_init, lora_init
from radialog_tpu.ops.layers import FP32 as JFP32
from radialog_tpu.parallel import tp_serving as jtp
from radialog_tpu_torch import bridge
from radialog_tpu_torch.decode import engine as te
from radialog_tpu_torch.models.llama import TINY_LLAMA
from radialog_tpu_torch.ops import quant as tquant
from radialog_tpu_torch.ops.layers import FP32
from radialog_tpu_torch.parallel import tp_serving as ttp

import test_torch_llama as tll
import torch_tp_ranks

DP = dict(max_new_tokens=6, eos_token_id=-1)
B, T = 8, 24
CASES = {
    "tp1_int8": dict(tp=1, img=True, lora=True, cache_len=64, kv_int8=True, prefix=False,
                     beams=1),
    "tp1_prefix": dict(tp=1, img=True, lora=True, cache_len=40, kv_int8=True, prefix=True,
                       beams=1),
    "tp1_beam": dict(tp=1, img=True, lora=True, cache_len=64, kv_int8=False, prefix=False,
                     beams=2),
    "tp2_int8": dict(tp=2, img=True, lora=True, cache_len=64, kv_int8=True, prefix=False,
                     beams=1),
    "tp2_bf16": dict(tp=2, img=False, lora=False, cache_len=64, kv_int8=False, prefix=False,
                     beams=1),
    "tp2_prefix": dict(tp=2, img=True, lora=True, cache_len=40, kv_int8=True, prefix=True,
                       beams=1),
    "tp2_beam": dict(tp=2, img=True, lora=True, cache_len=64, kv_int8=False, prefix=False,
                     beams=2),
    "tp2_w4": dict(tp=2, img=True, lora=True, cache_len=64, kv_int8=True, prefix=False,
                   beams=1, bits=4),
}
TP2 = [name for name in CASES if name.startswith("tp2")]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    cfg = JTINY
    key = jax.random.PRNGKey(0)
    host = _np(llama_init(key, cfg))
    lora = _np(lora_init(key, cfg))
    rng = np.random.default_rng(0)
    for t in lora["layers"]:   # a B that is not zero, so the adapters act
        lora["layers"][t]["b"] = (rng.normal(size=lora["layers"][t]["b"].shape)
                                  * 0.1).astype(np.float32)
    tokens = rng.integers(3, 200, (B, T)).astype(np.int32)
    lengths = rng.integers(12, T + 1, (B,)).astype(np.int32)
    for i in range(B):
        tokens[i, lengths[i]:] = 0
        tokens[i, 2:2 + cfg.num_img_tokens] = cfg.img_token_id
    img = (rng.normal(size=(B, cfg.num_img_tokens, cfg.qformer_dim)) * 0.1).astype(np.float32)
    return dict(host=host, lora=lora, tokens=tokens,
                tokens_noimg=np.where(tokens == cfg.img_token_id, 7, tokens),
                lengths=lengths, img=img, prefix=np.asarray([11, 12, 13, 14], np.int32))


@pytest.fixture(scope="module")
def jax_tokens(inputs):
    """JAX ``make_tp_generate`` at TP = 2 on a (data 4, model 2) CPU mesh,
    its flash-decode kernel in Pallas interpret mode (the function K2
    implements; the default CPU fallback is another)."""
    out = {}
    mesh = jmake_mesh(JMeshSpec(data=4, model=2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RADIALOG_FLASH_DECODE_FORCE", "interpret")
        for name in TP2:
            out[name] = _jax_case(inputs, mesh, name)
    return out


def _jax_case(inputs, mesh, name):
    c = CASES[name]
    gp, specs = jtp.shard_quantized_llama(inputs["host"], JTINY, 2, bits=c.get("bits", 8))
    gl, lspecs = jtp.shard_lora(inputs["lora"], JTINY, 2)
    fn = jtp.make_tp_generate(mesh, specs, JTINY, JDecodeParams(**DP), has_img=c["img"],
                              lora_specs=lspecs if c["lora"] else None, policy=JFP32,
                              cache_len=c["cache_len"], kv_int8=c["kv_int8"],
                              shared_prefix=c["prefix"], num_beams=c["beams"])
    res = fn(gp, inputs["tokens"] if c["img"] else inputs["tokens_noimg"], inputs["lengths"],
             img_embs=inputs["img"] if c["img"] else None, glora=gl if c["lora"] else None,
             prefix_tokens=inputs["prefix"] if c["prefix"] else None)
    return np.asarray(res.tokens)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Both ranks' results of every case."""
    job = dict(kind="serving", cfg=dataclasses.asdict(TINY_LLAMA), dp=DP, cases=CASES, **inputs)
    return torch_tp_ranks.run_ranks(job, 2, tmp_path_factory.mktemp("tp_serving"))


def test_shard_config_matches_jax():
    for n in (1, 2, 4):
        want = jtp.shard_config(JTINY, n)
        got = ttp.shard_config(TINY_LLAMA, n)
        for field in ("num_heads", "num_kv_heads", "intermediate_size", "head_dim",
                      "hidden_size", "vocab_size"):
            assert getattr(got, field) == getattr(want, field), (n, field)
    for cfg, fn in ((JTINY, jtp.shard_config), (TINY_LLAMA, ttp.shard_config)):
        with pytest.raises(ValueError, match="not divisible"):
            fn(cfg, 3)


def _leaf_equal(got, want):
    for attr in ("w", "scale", "gscale", "goff", "b"):
        g, w = getattr(got, attr, None), getattr(want, attr, None)
        assert (g is None) == (w is None), attr
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=attr)


@pytest.mark.parametrize("bits", [8, 4])
def test_rank_packs_are_jax_shard_leaves(bits, inputs):
    """Each rank packs its own slice: bitwise the JAX leaf [rank] of the
    stacked per-shard pack (row-parallel wo/down re-quantized over the
    shard's rows; at 4 bits the groups restart at the shard boundary);
    norms, embed and lm_head replicated."""
    gp, _ = jtp.shard_quantized_llama(inputs["host"], JTINY, 2, bits=bits)
    gp = tll.packed_tree(gp)
    cl = ttp.shard_config(TINY_LLAMA, 2)
    k_of = {"wqkv": cl.hidden_size, "gateup": cl.hidden_size,
            "wo": cl.num_heads * cl.head_dim, "down": cl.intermediate_size}
    for rank in range(2):
        got = ttp.shard_quantized_llama(inputs["host"], TINY_LLAMA, 2, rank, bits=bits,
                                        device="cpu")
        for lg, lw in zip(got["layers"], gp["layers"]):
            for name, k in k_of.items():
                leaf = {a: v[rank] if isinstance(v, np.ndarray) else v
                        for a, v in lw[name].items()}
                conv = bridge.packed_q4 if bits == 4 else bridge.packed_q8
                _leaf_equal(lg[name], conv(leaf, k, "cpu"))
            for name in ("input_ln", "post_ln"):
                np.testing.assert_array_equal(lg[name].numpy(), lw[name])
        _leaf_equal(got["lm_head"], bridge.packed_q8(gp["lm_head"], JTINY.hidden_size, "cpu"))
        np.testing.assert_array_equal(got["embed"].float().numpy(),
                                      np.asarray(gp["embed"], np.float32))
        np.testing.assert_array_equal(got["final_ln"].numpy(), gp["final_ln"])


def test_tp1_equals_unsharded_generate(inputs, ranks):
    """TP = 1 on a (data 2, model 1) mesh: each rank runs half the batch
    unsharded and the halves are gathered back in order: the port's own
    ``generate`` / ``generate_shared_prefix`` / ``generate_beam`` tokens."""
    from radialog_tpu_torch.decode.beam import generate_beam
    qp = tquant.quantize_llama_host(inputs["host"], device="cpu")
    lora = bridge.lora(inputs["lora"], "cpu")
    toks, lens = torch.from_numpy(inputs["tokens"]), torch.from_numpy(inputs["lengths"])
    img = torch.from_numpy(inputs["img"])
    dp = te.DecodeParams(**DP)
    want = {
        "tp1_int8": te.generate(qp, TINY_LLAMA, toks, lens, dp, img_embs=img, lora=lora,
                                policy=FP32, cache_len=64, kv_int8=True),
        "tp1_prefix": te.generate_shared_prefix(qp, TINY_LLAMA, torch.from_numpy(inputs["prefix"]),
                                                toks, lens, dp, img_embs=img, lora=lora,
                                                policy=FP32, cache_len=40, kv_int8=True),
        "tp1_beam": generate_beam(qp, TINY_LLAMA, toks, lens, dp, 2, img_embs=img, lora=lora,
                                  policy=FP32),
    }
    for name, res in want.items():
        for rank in range(2):
            np.testing.assert_array_equal(ranks[rank][name]["tokens"], res.tokens.numpy(),
                                          err_msg=f"{name} rank {rank}")
            np.testing.assert_array_equal(ranks[rank][name]["lengths"], res.lengths.numpy())


def test_ranks_agree(ranks):
    assert ranks[0]["init"] == ranks[1]["init"] == (True, True, "gloo")
    assert not ranks[0]["jax_imported"] and not ranks[1]["jax_imported"]
    for name in CASES:
        for key in ("tokens", "lengths", "prompt_lengths"):
            np.testing.assert_array_equal(ranks[0][name][key], ranks[1][name][key])
        assert ranks[0][name]["tokens"].shape == (B, DP["max_new_tokens"])


@pytest.mark.parametrize("name", TP2)
def test_tp2_matches_jax(name, ranks, jax_tokens):
    np.testing.assert_array_equal(ranks[0][name]["tokens"], jax_tokens[name])


def test_raises():
    for kw, err in ((dict(dp=te.DecodeParams(do_sample=True)), NotImplementedError),
                    (dict(num_beams=2, kv_int8=True), ValueError),
                    (dict(num_beams=2, kv_int8=False, shared_prefix=True), ValueError)):
        dp = kw.pop("dp", te.DecodeParams())
        with pytest.raises(err):
            ttp.make_tp_generate(None, TINY_LLAMA, dp, **kw)
    lora = {"layers": {"wo": {"a": torch.zeros(2, 64, 8), "b": torch.zeros(2, 8, 64)}},
            "scale": torch.tensor(2.0)}
    with pytest.raises(ValueError, match="q/k/v"):
        ttp.shard_lora(lora, TINY_LLAMA, 2, 0)
    fn = ttp.make_tp_generate(None, TINY_LLAMA, te.DecodeParams(), shared_prefix=True,
                              device="cpu")
    with pytest.raises(ValueError, match="shared_prefix"):
        fn({}, np.zeros((2, 4), np.int32), np.full((2,), 4, np.int32))
    with pytest.raises(ValueError, match="rank"):
        ttp.shard_quantized_llama({}, TINY_LLAMA, 2, 2)
