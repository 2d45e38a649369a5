"""Training math of the PyTorch port (radialog_tpu_torch/train, ops/quant.py's
training layout, the stacked layout of models/llama.py) against the JAX
package on the same numpy inputs and weights, FP32 policy unless stated.

Tolerances: schedules bit for bit (both compute in f32 in the same order;
JAX run op by op). The optimizer against optax's jitted chain: params
within 2.5e-7 after 7 micro-steps (op by op it is bitwise without the clip,
tests/test_torch_optim.py; jitted, XLA contracts multiply-adds into FMAs and
sums the clip's norm in its own order). Loss 1e-5 and LoRA gradients atol 2e-5 of
gradients up to ~1 (sums in another order). With the int8 base the policy
is BF16 on both sides: bf16 rounds at other places in the two frameworks, so
the loss is held at 2e-2 and gradients at 5e-2 of the largest one. Three
train steps: losses within 1e-5, the LoRA tree within 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radialog_tpu.models import llama as jl
from radialog_tpu.ops import layers as jlayers
from radialog_tpu.ops import quant as jquant
from radialog_tpu.train import optim as joptim
from radialog_tpu.train import steps as jsteps
from radialog_tpu_torch import bridge
from radialog_tpu_torch.models import llama as tl
from radialog_tpu_torch.ops import flash_attention as tfa
from radialog_tpu_torch.ops import layers as tlayers
from radialog_tpu_torch.ops import quant as tquant
from radialog_tpu_torch.train import optim as toptim
from radialog_tpu_torch.train import steps as tsteps


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaves_np(tree):
    """Leaves of a tree of either package as numpy, dicts in sorted key
    order (jax sorts keys, the port keeps insertion order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_np(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves_np(v)]
    return [tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


jax_leaves = leaves_np


# ------------------------------------------------------------------ the loss
def test_masked_ce_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 9, 17)).astype(np.float32)
    labels = rng.integers(0, 17, (3, 9)).astype(np.int32)
    labels[0, :5] = -100
    labels[2] = -100
    want = float(jsteps.masked_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tsteps.masked_ce(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) < 1e-6
    none = np.full((2, 4), -100, np.int32)
    assert float(tsteps.masked_ce(torch.from_numpy(logits[:2, :4]), torch.from_numpy(none))) == 0.0
    assert tsteps.IGNORE_INDEX == jsteps.IGNORE_INDEX


# ----------------------------------------------------------------- schedules
@pytest.mark.parametrize("name,kw", [
    ("linear_warmup_cosine", dict(init_lr=3e-4, min_lr=3e-5, warmup_steps=100, total_steps=400)),
    ("linear_warmup_cosine", dict(init_lr=1e-4, min_lr=1e-5, warmup_steps=10, total_steps=50,
                                  warmup_start_lr=1e-6)),
    ("linear_warmup_cosine", dict(init_lr=1e-3, min_lr=0.0, warmup_steps=0, total_steps=4)),
    # configs/stage1_pretrain.yaml's rates; apps/finetune_lora.py's (lr 3e-4,
    # min lr / 10, warm-up 100); a min-lr-0 tail, where 1 + cos(pi t) cancels
    ("linear_warmup_cosine", dict(init_lr=1e-4, min_lr=1e-5, warmup_steps=2000,
                                  total_steps=100000, warmup_start_lr=1e-6)),
    ("linear_warmup_cosine", dict(init_lr=3e-4, min_lr=3e-4 / 10, warmup_steps=100,
                                  total_steps=20000)),
    ("linear_warmup_cosine", dict(init_lr=3e-5, min_lr=0.0, warmup_steps=0, total_steps=5000)),
    ("linear_warmup_step", dict(init_lr=1e-4, min_lr=1e-5, warmup_steps=20, decay_rate=0.9,
                                steps_per_epoch=30)),
    ("linear_warmup_step", dict(init_lr=1e-4, min_lr=5e-5, warmup_steps=5, decay_rate=0.5,
                                steps_per_epoch=7, warmup_start_lr=1e-6)),
])
def test_schedules_match_jax(name, kw):
    """Bit for bit at the edges of each phase and at 200 steps spread over
    the schedule's length, the tail of the cosine included."""
    js, ts = getattr(joptim, name)(**kw), getattr(toptim, name)(**kw)
    total = kw.get("total_steps", 3000)
    steps = sorted({0, 1, 4, 5, 9, 10, 11, 19, 20, 21, 49, 50, 99, 100, 101, 250, 399, 400, 1000,
                    1999, 2000, 2001, *np.linspace(0, total + 10, 200).astype(int).tolist(),
                    *range(total - 20, total + 2)})
    for step in steps:
        got, want = ts(step), np.asarray(js(step))
        assert isinstance(got, np.float32)
        assert got.tobytes() == want.tobytes(), f"step {step}: {got!r} vs {want!r}"


# ----------------------------------------------------------------- optimizer
def small_tree(rng):
    return {"layers": {"wq": {"a": rng.normal(size=(2, 6, 3)).astype(np.float32),
                              "b": rng.normal(size=(2, 3, 6)).astype(np.float32)}},
            "img_proj": {"w": rng.normal(size=(5, 6)).astype(np.float32),
                         "b": rng.normal(size=(6,)).astype(np.float32)},
            "scale": np.asarray(2.0, np.float32)}


@pytest.mark.parametrize("accum,clip,wd", [(2, 1.0, 0.0), (2, 1.0, 0.05), (3, None, 0.05),
                                           (1, 0.5, 0.01)])
def test_adamw_matches_optax(accum, clip, wd):
    """AdamW + clip + accumulation over 7 micro-steps on a tree with 0-d,
    1-d, 2-d and 3-d leaves, against optax's chain jitted as the JAX train
    step runs it; the gradients are large enough for the clip to bite on
    some steps and not on others. Not bitwise: under jit XLA contracts the
    moment updates' multiply-adds into FMAs (eager optax does not; the port
    is bitwise eager optax, tests/test_torch_optim.py) and sums the clip's
    norm in its fused order. The largest gap measured is 2.4e-7, one ulp of
    a parameter in [2, 4); the bar was 1e-6 before the port took optax's
    divisors and square roots."""
    rng = np.random.default_rng(1)
    params = small_tree(rng)
    kw = dict(weight_decay=wd, grad_clip=clip, accum_steps=accum)
    sched = dict(init_lr=3e-3, min_lr=3e-4, warmup_steps=2, total_steps=6)
    jtx = joptim.make_adamw(joptim.linear_warmup_cosine(**sched), **kw)
    ttx = toptim.make_adamw(toptim.linear_warmup_cosine(**sched), **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = bridge.to_torch(params, "cpu")
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for step in range(7):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * (0.05 if step % 3 else 1.0)).astype(np.float32),
            params)
        jup, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, jup)
        tup, tstate = ttx.update(bridge.to_torch(grads, "cpu"), tstate, tp)
        moved = tup is not None
        tp = toptim.apply_updates(tp, tup)
        assert moved == ((step + 1) % accum == 0)
        for got, want in zip(leaves_np(tp), jax_leaves(jp)):
            np.testing.assert_allclose(got, want, rtol=0, atol=2.5e-7, err_msg=f"step {step}")
    inner = tstate["inner"] if accum > 1 else tstate
    assert inner["count"] == 7 // accum


def test_sgd_and_unknown_optimizer():
    rng = np.random.default_rng(2)
    params = small_tree(rng)
    jtx = joptim.make_optimizer("sgd", learning_rate=0.1, momentum=0.8)
    ttx = toptim.make_optimizer("sgd", learning_rate=0.1, momentum=0.8)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), bridge.to_torch(params, "cpu")
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                                       params)
        jup, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, jup)
        tup, tstate = ttx.update(bridge.to_torch(grads, "cpu"), tstate, tp)
        tp = toptim.apply_updates(tp, tup)
    for got, want in zip(leaves_np(tp), jax_leaves(jp)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.make_optimizer("lion")


# ------------------------------------------------------- the int8 base layout
def test_quantize_weight_and_linear_q8_match_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(2, 24, 10)).astype(np.float32)
    w[0, :, 3] = 0.0                                     # a dead channel: the scale floor
    jq, tq = jquant.quantize_weight(jnp.asarray(w)), tquant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq["w_q"].numpy(), np.asarray(jq["w_q"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    np.testing.assert_allclose(tquant.dequantize_weight(tq).numpy(),
                               np.asarray(jquant.dequantize_weight(jq)), rtol=1e-7)
    assert tquant.is_quantized(tq) and not tquant.is_quantized({"w": w})
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    b = rng.normal(size=(10,)).astype(np.float32)
    jleaf = {"w_q": jq["w_q"][0], "scale": jq["scale"][0], "b": jnp.asarray(b)}
    tleaf = {"w_q": tq["w_q"][0], "scale": tq["scale"][0], "b": torch.from_numpy(b)}
    want = np.asarray(jquant.linear_q8(jleaf, jnp.asarray(x), jnp.float32))
    got = tquant.linear_q8(tleaf, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # through ops/layers.linear, and its gradient in x against jax.grad
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tlayers.linear(tleaf, xt, tlayers.FP32)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    cot = rng.normal(size=want.shape).astype(np.float32)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(cot))
    jgx = jax.grad(lambda x_: jnp.sum(jlayers.linear(jleaf, x_, jlayers.FP32) * cot))(
        jnp.asarray(x))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)


def test_quantize_llama_np_matches_jax():
    params = as_np(jl.llama_init(jax.random.PRNGKey(4), jl.TINY_LLAMA))
    want = as_np(jquant.quantize_llama_np(params))
    got = tquant.quantize_llama_np(params, device="cpu")
    wl, gl = leaves_np(want), leaves_np(toptim.tree_map(
        lambda x: x.float() if x.dtype == torch.bfloat16 else x, got))
    assert len(wl) == len(gl) == 20
    for g, w in zip(gl, wl):
        assert g.shape == w.shape and g.dtype.name == w.dtype.name.replace("bfloat16", "float32")
        np.testing.assert_array_equal(g.astype(np.float32), w.astype(np.float32))
    assert got["embed"].dtype == torch.bfloat16 and got["layers"]["wq"]["w_q"].dtype == torch.int8
    # the float embedding and lm_head of quantize_embed=False
    got = tquant.quantize_llama_np(params, device="cpu", quantize_embed=False)
    assert got["embed"].dtype == torch.float32 and "w" in got["lm_head"]


def test_random_q8_train_base_layout():
    cfg = dataclasses.replace(tl.TINY_LLAMA, num_kv_heads=2)
    base = tquant.random_q8_train_base(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = tquant.quantize_llama(tl.llama_init(torch.Generator().manual_seed(0), cfg, "cpu"))
    for g, w in zip(toptim.tree_leaves(base), toptim.tree_leaves(ref)):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert list(base["layers"]) == list(ref["layers"])
    x = torch.randn(2, 5, cfg.hidden_size)
    y = tlayers.linear({k: v[0] for k, v in base["layers"]["gate"].items()}, x, tlayers.FP32)
    assert 0.5 < float(y.std()) < 2.0                    # activations keep unit scale


# ------------------------------------------------------- loss and gradients
def tiny(max_position=128, quantize=False, seed=5):
    """(JAX cfg, JAX base, JAX lora, port cfg, port base, port lora) with a
    nonzero LoRA B, so every adapter leaf has a gradient."""
    jcfg = dataclasses.replace(jl.TINY_LLAMA, max_position=max_position)
    tcfg = dataclasses.replace(tl.TINY_LLAMA, max_position=max_position)
    base = jl.llama_init(jax.random.PRNGKey(seed), jcfg)
    if quantize:
        base = jquant.quantize_llama(base)
    lora = jl.lora_init(jax.random.PRNGKey(seed + 1), jcfg)
    rng = np.random.default_rng(seed)
    for t in lora["layers"]:
        lora["layers"][t]["b"] = jnp.asarray(
            rng.normal(size=lora["layers"][t]["b"].shape).astype(np.float32) * 0.1)
    return (jcfg, base, lora, tcfg, bridge.llama_stacked(as_np(base), "cpu"),
            bridge.lora(as_np(lora), "cpu"))


def make_batch(cfg, b, t, lens, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, cfg.vocab_size - 10, (b, t)).astype(np.int32)
    labels = tokens.copy()
    for i, n in enumerate(lens):
        tokens[i, n:] = 0
        labels[i, n:] = -100
        labels[i, :n // 3] = -100
    tokens[:, 2:2 + cfg.num_img_tokens] = cfg.img_token_id
    return {"tokens": tokens, "labels": labels, "lengths": np.asarray(lens, np.int32),
            "img_embs": rng.normal(size=(b, cfg.num_img_tokens, cfg.qformer_dim))
            .astype(np.float32)}


def port_loss_and_grads(lora, base, cfg, batch, policy, remat, flash):
    params = toptim.tree_map(lambda p: p.clone().requires_grad_(True), lora)
    loss = tsteps.lora_loss_fn(params, base, cfg, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()},
                               policy, remat, flash)
    leaves = toptim.tree_leaves(params)
    found = iter(torch.autograd.grad(loss, leaves))
    return float(loss.detach()), leaves_np(toptim.tree_map(lambda p: next(found), params))


@pytest.mark.parametrize("t,lens,flash,quantize", [
    (64, [64, 41], False, False),     # mha
    (256, [256, 170], True, False),   # the port's flash path against JAX's mha path
    (64, [64, 41], False, True),      # int8 base, BF16 policy
])
def test_lora_loss_and_grads_match_jax(t, lens, flash, quantize):
    jcfg, jbase, jlora, tcfg, tbase, tlora = tiny(max(t, 128), quantize)
    batch = make_batch(tcfg, 2, t, lens)
    jpol, tpol = (jlayers.BF16, tlayers.BF16) if quantize else (jlayers.FP32, tlayers.FP32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda lo: jsteps.lora_loss_fn(lo, jbase, jcfg, jbatch, jpol, False, flash)))(jlora)
    jgrads = jax_leaves(jgrads)
    launched = []
    if flash:   # the flash path must be the one that ran
        orig = tfa.flash_attention_bwd_plain
        tfa.flash_attention_bwd_plain = lambda *a, **kw: (launched.append(1), orig(*a, **kw))[1]
    try:
        got, grads = port_loss_and_grads(tlora, tbase, tcfg, batch, tpol, False, flash)
        got_r, grads_r = port_loss_and_grads(tlora, tbase, tcfg, batch, tpol, True, flash)
    finally:
        if flash:
            tfa.flash_attention_bwd_plain = orig
    assert len(launched) == (2 * tcfg.num_layers if flash else 0)
    loss_tol, rel = (2e-2, 5e-2) if quantize else (1e-5, 0.0)
    assert abs(got - float(want)) < loss_tol
    gmax = max(float(np.abs(g).max()) for g in jgrads)
    assert gmax > 1e-3
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 + rel * gmax)
    # remat recomputes the same operations: equal bit for bit
    assert got_r == got
    for g, w in zip(grads_r, grads):
        np.testing.assert_array_equal(g, w)


def test_flash_false_keeps_mha_and_stacked_layout_refuses_a_cache():
    _, _, _, tcfg, tbase, tlora = tiny(256)
    batch = make_batch(tcfg, 1, 256, [200])
    calls = []
    orig = tfa.flash_attention_plain
    tfa.flash_attention_plain = lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1]
    try:
        a, _ = port_loss_and_grads(tlora, tbase, tcfg, batch, tlayers.FP32, False, False)
        assert not calls
        b, _ = port_loss_and_grads(tlora, tbase, tcfg, batch, tlayers.FP32, False, True)
        assert len(calls) == tcfg.num_layers
    finally:
        tfa.flash_attention_plain = orig
    assert abs(a - b) < 1e-5
    # the stacked layout takes the bf16 cache (the float path) but, as in the
    # JAX package, refuses the int8 one, init_cache's default in the port
    tokens = torch.from_numpy(batch["tokens"])
    with pytest.raises(ValueError, match="int8 KV caches require the unrolled serving params"):
        tl.llama_apply(tbase, tcfg, tokens, tokens, None,
                       cache=tl.init_cache(tcfg, 1, 256, device="cpu"))


def test_stacked_layout_returns_fresh_kv_and_gqa_matches_jax():
    """A forward without remat returns the per-layer K/V as the JAX stacked
    prefill does; with grouped-query heads K/V are repeated before attention."""
    jcfg = dataclasses.replace(jl.TINY_LLAMA, num_kv_heads=2)
    tcfg = dataclasses.replace(tl.TINY_LLAMA, num_kv_heads=2)
    base = jl.llama_init(jax.random.PRNGKey(8), jcfg)
    tbase = bridge.llama_stacked(as_np(base), "cpu")
    batch = make_batch(tcfg, 2, 24, [24, 13])
    lens = batch["lengths"]
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    jlogits, jkv = jl.llama_apply(base, jcfg, jnp.asarray(batch["tokens"]), jnp.asarray(pos),
                                  jl.prefill_bias(jnp.asarray(lens), 24), lengths=jnp.asarray(lens))
    with torch.no_grad():
        logits, kv = tl.llama_apply(tbase, tcfg, torch.from_numpy(batch["tokens"]),
                                    torch.from_numpy(pos),
                                    tl.prefill_bias(torch.from_numpy(lens), 24),
                                    lengths=torch.from_numpy(lens), remat=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=2e-5)
    assert kv.k.shape == (2, 2, 24, 2, 16)
    np.testing.assert_allclose(kv.k.numpy(), np.asarray(jkv.k), rtol=0, atol=1e-5)
    np.testing.assert_allclose(kv.v.numpy(), np.asarray(jkv.v), rtol=0, atol=1e-5)


# ------------------------------------------------------------ the train step
def test_three_train_steps_match_jax():
    jcfg, jbase, jlora, tcfg, tbase, tlora = tiny()
    sched = dict(init_lr=3e-4, min_lr=3e-5, warmup_steps=100, total_steps=3)
    kw = dict(weight_decay=0.0, grad_clip=1.0, accum_steps=2)
    jtx = joptim.make_adamw(joptim.linear_warmup_cosine(**sched), **kw)
    ttx = toptim.make_adamw(toptim.linear_warmup_cosine(**sched), **kw)
    jstate = jsteps.TrainState.create(jlora, jtx)
    tstate = tsteps.TrainState.create(tlora, ttx)
    jstep = jax.jit(jsteps.make_lora_train_step(jtx, jcfg))
    tstep = tsteps.make_lora_train_step(ttx, tcfg)
    for i in range(3):
        batch = make_batch(tcfg, 2, 48, [48, 30 + i], seed=i)
        jstate, jm = jstep(jstate, jbase, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, tbase, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-5
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert not any(p.requires_grad for p in toptim.tree_leaves(tstate.params))
    assert tstate.step == 3 == int(jstate.step)
    assert tstate.opt_state["gradient_step"] == 1 and tstate.opt_state["mini_step"] == 1
    moved = 0.0
    for got, want, start in zip(leaves_np(tstate.params), jax_leaves(jstate.params),
                                jax_leaves(jlora)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        moved = max(moved, float(np.abs(want - start).max()))
    assert moved > 1e-4                                   # one update was applied
    # the optimizer state crosses the bridge too
    inner = jstate.opt_state.inner_opt_state
    adam = next(s for s in jax.tree_util.tree_leaves(inner, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))
    carried = bridge.adamw_state({"mini_step": np.asarray(jstate.opt_state.mini_step),
                                  "gradient_step": np.asarray(jstate.opt_state.gradient_step),
                                  "acc": as_np(jstate.opt_state.acc_grads),
                                  "inner": {"count": np.asarray(adam.count),
                                            "mu": as_np(adam.mu), "nu": as_np(adam.nu)}}, "cpu")
    assert carried["mini_step"] == 1 and carried["inner"]["count"] == 1
    for name in ("mu", "nu"):
        for got, want in zip(leaves_np(tstate.opt_state["inner"][name]),
                             leaves_np(carried["inner"][name])):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
