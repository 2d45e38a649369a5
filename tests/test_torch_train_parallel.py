"""One LoRA training step of the port across ranks (models/llama.py's
Megatron pair, train/steps.py ``make_lora_train_step(mesh=...)``,
train/optim.py's sharded ``global_norm``) against the JAX package's
unsharded ``make_lora_train_step`` on the same global batch and weights.

Gloo rank processes (tests/torch_tp_ranks.py): two on (1, 2) and (2, 1)
meshes (TP = 2, DP = 2), four on (2, 2). SGD at learning rate 1, so the
updated params are the params minus the gradient: the check holds the
sharded gradients themselves (AdamW's first step is a sign, which would
hide a factor of 2; tests/test_stage1_multichip.py says the same). Remat on,
vocabulary 257 (not divided by 2), the float and the int8 base, FP32 policy,
the data ranks' rows with different counts of valid labels, LoRA ``b`` and
the image splice live so that every adapter leaf has a gradient.

Tolerances, JAX's own bars (tests/test_stage1_multichip.py): loss and
grad_norm within 1e-5, params within 2e-5 (f32 sums in another order).

The f-op regression: with the identity in place of ``copy_to_group`` (the
behaviour before it: the all-reduce's backward the identity, no "f"),
the gradients of img_proj, layer 0's ``a`` and the scale part from JAX's by
far more than the bar, so the check above fails on such a build.

The timeout: a rank that raises inside the backward leaves its peer in a
collective, which raises at the mesh's timeout instead of hanging.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from radialog_tpu.models import llama as jl
from radialog_tpu.ops import layers as jlayers
from radialog_tpu.ops import quant as jquant
from radialog_tpu.train import steps as jsteps
from radialog_tpu_torch import bridge

import torch_tp_ranks

B, T, T_FLASH, LR = 4, 24, 256, 1.0
VALID = [T - 2, T - 4, 6, 3]     # labels per row: the data ranks' counts differ
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=2e-5, atol=2e-5)
LEAVES = ["layers/wq/a", "layers/wq/b", "layers/wv/a", "layers/wv/b", "img_proj/w",
          "img_proj/b", "scale"]


def _flat(tree):
    """{leaf path: numpy} of a JAX LoRA tree, over LEAVES."""
    out = {}
    for path in LEAVES:
        x = tree
        for k in path.split("/"):
            x = x[k]
        out[path] = np.asarray(x)
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(quantized, seed=0):
    cfg = dataclasses.replace(jl.TINY_LLAMA, vocab_size=257, max_position=T_FLASH)
    base = _np(jl.llama_init(jax.random.PRNGKey(seed), cfg))
    if quantized:
        base = _np(jquant.quantize_llama(base))
    lora = _np(jl.lora_init(jax.random.PRNGKey(seed + 1), cfg))
    rng = np.random.default_rng(seed)
    for t in lora["layers"]:
        lora["layers"][t]["b"] = (rng.normal(size=lora["layers"][t]["b"].shape)
                                  * 0.1).astype(np.float32)
    return cfg, base, lora


def _batch(cfg, t, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, cfg.vocab_size - 1, (B, t)).astype(np.int32)
    tokens[:, 2:2 + cfg.num_img_tokens] = cfg.img_token_id
    tokens[1, 9] = cfg.vocab_size - 1           # the vocabulary's last row
    lengths = np.asarray([t, t - 2, t, t - 7], np.int32)
    labels = np.full((B, t), -100, np.int32)
    for i, n in enumerate(VALID):
        n = min(n, lengths[i] - 1)
        labels[i, lengths[i] - n:lengths[i]] = tokens[i, lengths[i] - n:lengths[i]]
    for i in range(B):
        tokens[i, lengths[i]:] = 0
    return {"tokens": tokens, "labels": labels, "lengths": lengths,
            "img_embs": rng.normal(size=(B, cfg.num_img_tokens, cfg.qformer_dim))
            .astype(np.float32)}


def _jax_step(cfg, base, lora, batch):
    tx = optax.sgd(LR)
    step = jax.jit(jsteps.make_lora_train_step(tx, cfg, policy=jlayers.FP32, remat=True))
    state, m = step(jsteps.TrainState.create(jax.tree_util.tree_map(jnp.asarray, lora), tx),
                    jax.tree_util.tree_map(jnp.asarray, base),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _flat(state.params)}


def _case(cfg, base, lora, batch, mesh, **kw):
    return dict(cfg=dataclasses.asdict(cfg), base=bridge.llama_stacked(base, "cpu"),
                lora=bridge.lora(lora, "cpu"), batch=batch, mesh=mesh, **kw)


@pytest.fixture(scope="module")
def setup():
    """The JAX references and the cases' inputs."""
    out = {}
    for quantized in (False, True):
        cfg, base, lora = _models(quantized)
        batch = _batch(cfg, T)
        out["int8" if quantized else "float"] = (cfg, base, lora, batch,
                                                 _jax_step(cfg, base, lora, batch))
    cfg, base, lora = _models(False)
    batch = _batch(cfg, T_FLASH, seed=1)
    out["flash"] = (cfg, base, lora, batch, _jax_step(cfg, base, lora, batch))
    return out


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    cases = {}
    for kind in ("float", "int8"):
        cfg, base, lora, batch, _ = setup[kind]
        cases[f"tp2_{kind}"] = _case(cfg, base, lora, batch, (1, 2))
        cases[f"dp2_{kind}"] = _case(cfg, base, lora, batch, (2, 1))
    cfg, base, lora, batch, _ = setup["float"]
    cases["tp2_no_f"] = _case(cfg, base, lora, batch, (1, 2), no_f=True)
    cfg, base, lora, batch, _ = setup["flash"]
    cases["tp2_flash"] = _case(cfg, base, lora, batch, (1, 2), flash=True)
    return torch_tp_ranks.run_ranks({"kind": "train", "lr": LR, "cases": cases}, 2,
                                    tmp_path_factory.mktemp("train2"))


@pytest.fixture(scope="module")
def four_ranks(setup, tmp_path_factory):
    cases = {f"tp2dp2_{kind}": _case(*setup[kind][:4], (2, 2)) for kind in ("float", "int8")}
    return torch_tp_ranks.run_ranks({"kind": "train", "lr": LR, "cases": cases}, 4,
                                    tmp_path_factory.mktemp("train4"))


def _held(got, want):
    """Per leaf: the gathered params within PARAM_TOL of JAX's."""
    return {leaf: np.allclose(got["params"][leaf], want["params"][leaf], **PARAM_TOL)
            for leaf in LEAVES}


def _check(ranks, name, want):
    for out in ranks:
        got = out[name]
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **TOL)
        assert sorted(got["params"]) == sorted(LEAVES)
        for leaf in LEAVES:
            np.testing.assert_allclose(got["params"][leaf], want["params"][leaf], **PARAM_TOL,
                                       err_msg=f"{name} {leaf}")
        assert not out["jax_imported"]


@pytest.mark.parametrize("mesh", ["tp2", "dp2"])
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_two_ranks_match_jax_unsharded(setup, two_ranks, mesh, kind):
    _check(two_ranks, f"{mesh}_{kind}", setup[kind][4])


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_four_ranks_match_jax_unsharded(setup, four_ranks, kind):
    _check(four_ranks, f"tp2dp2_{kind}", setup[kind][4])


def test_flash_at_the_shards_head_count(setup, two_ranks):
    """T = 256: attention through flash_attention's forward and backward
    (their plain versions on the CPU) at 2 of TINY's 4 heads a rank, against
    JAX's unsharded mha step."""
    _check(two_ranks, "tp2_flash", setup["flash"][4])


def test_replicated_leaves_equal_on_every_rank(two_ranks, four_ranks):
    """a, img_proj and scale: bitwise the same after the step on every rank
    (the sums give each rank the same bits); b differs (split)."""
    for ranks, name, peers in ((two_ranks, "tp2_float", [(0, 1)]),
                               (two_ranks, "dp2_int8", [(0, 1)]),
                               (four_ranks, "tp2dp2_float", [(0, 1), (2, 3), (0, 2)])):
        for i, j in peers:
            for leaf in LEAVES:
                x, y = ranks[i][name]["local"][leaf], ranks[j][name]["local"][leaf]
                if leaf.endswith("/b") and leaf.startswith("layers") and name.startswith("tp"):
                    if (i, j) != (0, 2):
                        assert x.shape == y.shape and not np.array_equal(x, y), leaf
                    continue
                np.testing.assert_array_equal(x, y, err_msg=f"{name} {leaf} ranks {i} {j}")


def test_f_op_closes_the_partial_gradient_trap(setup, two_ranks):
    """With f the gradients of img_proj, layer 0's a and b, and the scale are
    JAX's; with the identity in its place (no gradient sum at the
    column-parallel inputs) img_proj, a and the scale are not: the check of
    test_two_ranks_match_jax_unsharded fails on such a build."""
    want = setup["float"][4]
    held = _held(two_ranks[0]["tp2_float"], want)
    assert all(held.values()), held
    without = _held(two_ranks[0]["tp2_no_f"], want)
    for leaf in ("img_proj/w", "layers/wq/a", "layers/wv/a", "scale"):
        assert not without[leaf], leaf


def test_collectives_per_step(two_ranks):
    """The all-reduces of one TP = 2 micro-step of 2 layers: f's backward at
    q/k/v and gate/up of each layer and at the lm_head (5); g forward after
    each wo and down and at the embedding (5), plus remat's replays of the
    attention's g (the mlp's g ends the layer, whose replay stops before
    it); the step's own sums (label count, gradients over data and over
    model, the clip-free norm, the loss)."""
    calls = two_ranks[0]["tp2_float"]["calls"]
    assert calls["copy_to_group"] == 5
    assert 5 < calls["reduce_from_group"] <= 9
    assert calls["sum_over"] == 5
    assert two_ranks[0]["dp2_float"]["calls"]["copy_to_group"] == 5   # a group of one


@pytest.fixture(scope="module")
def timed_out(setup, tmp_path_factory):
    cfg, base, lora, batch, _ = setup["float"]
    return torch_tp_ranks.run_ranks(
        {"kind": "timeout", "timeout": 3.0, "cfg": dataclasses.asdict(cfg),
         "base": bridge.llama_stacked(base, "cpu"), "lora": bridge.lora(lora, "cpu"),
         "batch": batch}, 2, tmp_path_factory.mktemp("timeout"), timeout=120)


def test_a_rank_that_raises_in_backward_times_its_peer_out(timed_out):
    assert "injected failure" in timed_out[1]["raised"]
    assert timed_out[0]["raised"] is not None        # not a hang: the collective gave up
    assert 2.0 < timed_out[0]["seconds"] < 60
