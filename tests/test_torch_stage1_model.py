"""The stage-1 model of the PyTorch port (models/qformer.py's four entry
points, the LM head and loss; models/blip2.py's init, losses, gradients and
caption decoding) against the JAX package on the same numpy inputs, weights
carried over by bridge.blip2, FP32 policy unless stated.

The hard negatives: the port's ``sample_negatives`` is replaced by
``jax.random.categorical`` on the JAX key's two halves, as the JAX loss
draws them, so both sides train on the same negatives.

Tolerances (float32 on both sides, sums in another order): hidden states,
K/V and logits rtol = atol = 1e-5; the losses 1e-5; every gradient leaf
within 2e-5 of its largest entry, or of 1e-4 where that is smaller (plus
rtol 1e-4). Under the BF16 policy
bf16 rounds at other places in the two frameworks: the losses within 2e-2.
Caption tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.models import blip2 as jb
from radialog_tpu.models import qformer as jq
from radialog_tpu.ops import layers as jlayers
from radialog_tpu_torch import bridge
from radialog_tpu_torch.models import blip2 as tb
from radialog_tpu_torch.models import qformer as tq
from radialog_tpu_torch.ops import layers as tlayers
from radialog_tpu_torch.train import optim as toptim

TOL = dict(rtol=1e-5, atol=1e-5)


def two_layers(q):
    """TINY_QFORMER cut to 2 layers (one with cross-attention, one without):
    the JAX gradient compiles in a third of the 4-layer time."""
    return dataclasses.replace(q, bert=dataclasses.replace(q.bert, num_layers=2))


JCFG = jb.Blip2Config(qformer=two_layers(jq.TINY_QFORMER), max_txt_len=16)
TCFG = tb.Blip2Config(qformer=two_layers(tq.TINY_QFORMER), max_txt_len=16)
B, N, T = 4, 6, 10


def flat(tree, prefix=""):
    """{path: numpy leaf} of a tree of either package (dict keys sorted)."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in flat(x, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def setup():
    jparams, _ = jb.blip2_init(jax.random.PRNGKey(3), JCFG, with_vision=False)
    # a temp of other than its init, so that a lost division by it shows
    jparams["temp"] = jnp.asarray(0.09, jnp.float32)
    tparams, _ = bridge.blip2(jax.tree_util.tree_map(np.asarray, jparams), {}, device="cpu")
    rng = np.random.default_rng(0)
    embeds = rng.normal(size=(B, N, 48)).astype(np.float32)
    ids = rng.integers(4, 110, (B, T)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((B, T), np.int32)
    for row, n in enumerate([10, 7, 5, 9]):
        ids[row, n:] = 0
        mask[row, n:] = 0
    return jparams, tparams, embeds, ids, mask


def jax_negatives(key):
    """The port's sampler drawing what the JAX loss draws with ``key``."""
    k1, k2 = jax.random.split(key)

    def draw(w_t2i, w_i2t, gen):
        neg_img = jax.random.categorical(k1, jnp.log(jnp.asarray(w_t2i.numpy())))
        neg_txt = jax.random.categorical(k2, jnp.log(jnp.asarray(w_i2t.numpy())))
        return (torch.from_numpy(np.asarray(neg_img)).long(),
                torch.from_numpy(np.asarray(neg_txt)).long())
    return draw


def test_blip2_init_tree_matches_jax():
    jcfg = jb.Blip2Config(qformer=jq.TINY_QFORMER)
    jparams, jstate = jb.blip2_init(jax.random.PRNGKey(0), jcfg, with_vision=True)
    tparams, tstate = tb.blip2_init(torch.Generator().manual_seed(0),
                                    tb.Blip2Config(qformer=tq.TINY_QFORMER), "cpu",
                                    with_vision=True)
    for j, t in ((jparams, tparams), (jstate, tstate)):
        jf, tf = flat(j), flat(t)
        assert sorted(jf) == sorted(tf)
        assert {k: v.shape for k, v in jf.items()} == {k: v.shape for k, v in tf.items()}
        assert {k: v.dtype for k, v in jf.items()} == {k: v.dtype for k, v in tf.items()}
    assert float(tparams["temp"]) == pytest.approx(0.07)


def test_qformer_entry_points(setup):
    jparams, tparams, embeds, ids, mask = setup
    jqp, tqp, jc, tc = jparams["qformer"], tparams["qformer"], JCFG.qformer, TCFG.qformer
    e, i, m = torch.from_numpy(embeds), torch.from_numpy(ids), torch.from_numpy(mask)
    img_mask = np.ones((B, N), np.int32)
    img_mask[1, 4:] = 0
    for im in (None, img_mask):
        jh, jcache = jq.qformer_image_grounded(jqp, jc, jnp.asarray(embeds),
                                               None if im is None else jnp.asarray(im),
                                               use_cache=True)
        th, tcache = tq.qformer_image_grounded(tqp, tc, e,
                                               None if im is None else torch.from_numpy(im),
                                               use_cache=True)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        for (jk, jv), (tk, tv) in zip(jcache, tcache):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
        if im is None:   # without use_cache the port returns the hidden states alone
            assert torch.equal(tq.qformer_image_grounded(tqp, tc, e), th)
    np.testing.assert_allclose(
        tq.qformer_text(tqp, tc, i, m).numpy(),
        np.asarray(jq.qformer_text(jqp, jc, jnp.asarray(ids), jnp.asarray(mask))), **TOL)
    attn = np.concatenate([np.ones((B, 8), np.int32), mask], 1)
    np.testing.assert_allclose(
        tq.qformer_multimodal(tqp, tc, i, m.new_tensor(attn), e).numpy(),
        np.asarray(jq.qformer_multimodal(jqp, jc, jnp.asarray(ids), jnp.asarray(attn),
                                         jnp.asarray(embeds))), **TOL)
    _, jcache = jq.qformer_image_grounded(jqp, jc, jnp.asarray(embeds), use_cache=True)
    _, tcache = tq.qformer_image_grounded(tqp, tc, e, use_cache=True)
    np.testing.assert_allclose(
        tq.qformer_lm(tqp, tc, i, m.new_tensor(attn), tcache).numpy(),
        np.asarray(jq.qformer_lm(jqp, jc, jnp.asarray(ids), jnp.asarray(attn), jcache)),
        **TOL)


def test_lm_head_lm_loss_and_smoothed_ce(setup):
    jparams, tparams, _, ids, _ = setup
    rng = np.random.default_rng(1)
    hidden = rng.normal(size=(B, T, 32)).astype(np.float32)
    jl = jq.qformer_lm_head(jparams["qformer"], jnp.asarray(hidden))
    tl = tq.qformer_lm_head(tparams["qformer"], torch.from_numpy(hidden))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the BF16 policy: operands rounded to bf16, products summed in f32
    jlb = jq.qformer_lm_head(jparams["qformer"], jnp.asarray(hidden), jlayers.BF16)
    tlb = tq.qformer_lm_head(tparams["qformer"], torch.from_numpy(hidden), tlayers.BF16)
    assert tlb.dtype == torch.float32
    np.testing.assert_allclose(tlb.numpy(), np.asarray(jlb), rtol=2e-2, atol=2e-2)
    labels = np.where(ids == 0, -100, ids)
    labels[3] = -100     # a row with nothing to predict
    for ls in (0.0, 0.1):
        np.testing.assert_allclose(
            float(tq.lm_loss(tl, torch.from_numpy(labels), ls)),
            float(jq.lm_loss(jl, jnp.asarray(labels), ls)), **TOL)
    logits = rng.normal(size=(5, 7)).astype(np.float32)
    targets = rng.integers(0, 7, 5)
    for sm in (0.0, 0.1):
        np.testing.assert_allclose(
            float(tb._smoothed_ce(torch.from_numpy(logits), torch.from_numpy(targets), sm)),
            float(jb._smoothed_ce(jnp.asarray(logits), jnp.asarray(targets), sm)), **TOL)


def _jax_losses(jparams, embeds, ids, mask, key, itm_chunks, policy=jlayers.FP32,
                grads=True):
    def loss_fn(p):
        out = jb.blip2_stage1_losses(p, JCFG, jnp.asarray(embeds), jnp.asarray(ids),
                                     jnp.asarray(mask), key, policy=policy,
                                     itm_chunks=itm_chunks)
        return out.loss, out
    if not grads:
        return jax.jit(loss_fn)(jparams)[1], None
    (_, out), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    return out, g


def _port_losses(tparams, embeds, ids, mask, itm_chunks, policy=tlayers.FP32):
    params = toptim.tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    out = tb.blip2_stage1_losses(params, TCFG, torch.from_numpy(embeds), torch.from_numpy(ids),
                                 torch.from_numpy(mask), None, policy=policy,
                                 itm_chunks=itm_chunks)
    out.loss.backward()
    return out, toptim.tree_map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad,
                                params)


@pytest.mark.parametrize("itm_chunks", [1, 3])
def test_stage1_losses_and_every_gradient(setup, monkeypatch, itm_chunks):
    jparams, tparams, embeds, ids, mask = setup
    key = jax.random.PRNGKey(7)
    monkeypatch.setattr(tb, "sample_negatives", jax_negatives(key))
    jout, jgrads = _jax_losses(jparams, embeds, ids, mask, key, itm_chunks)
    tout, tgrads = _port_losses(tparams, embeds, ids, mask, itm_chunks)
    for name in ("loss", "loss_itc", "loss_itm", "loss_lm"):
        np.testing.assert_allclose(float(getattr(tout, name).detach()),
                                   float(getattr(jout, name)), **TOL, err_msg=name)
    jf, tf = flat(jgrads), flat(tgrads)
    assert sorted(jf) == sorted(tf) and len(tf) > 50
    for k in jf:
        # floor: the key biases' gradient is 0 in exact arithmetic (softmax
        # ignores a shift of every score), leaving rounding noise of ~1e-10
        scale = max(float(np.abs(jf[k]).max()), 1e-4)
        np.testing.assert_allclose(tf[k], jf[k], rtol=1e-4, atol=2e-5 * scale, err_msg=k)
    assert float(np.abs(tf["/temp"])) > 0 and np.abs(tf["/ln_vision/scale"]).max() == 0


def test_stage1_losses_bf16(setup, monkeypatch):
    jparams, tparams, embeds, ids, mask = setup
    key = jax.random.PRNGKey(7)
    monkeypatch.setattr(tb, "sample_negatives", jax_negatives(key))
    jout, _ = _jax_losses(jparams, embeds, ids, mask, key, 1, jlayers.BF16, grads=False)
    tout, tgrads = _port_losses(tparams, embeds, ids, mask, 1, tlayers.BF16)
    for name in ("loss", "loss_itc", "loss_itm", "loss_lm"):
        np.testing.assert_allclose(float(getattr(tout, name).detach()),
                                   float(getattr(jout, name)), rtol=2e-2, atol=2e-2, err_msg=name)
    assert all(np.isfinite(v).all() for v in flat(tgrads).values())


def test_itm_chunks_must_divide_three_batches(setup):
    _, tparams, embeds, ids, mask = setup
    with pytest.raises(ValueError, match="must divide"):
        tb.blip2_stage1_losses(tparams, TCFG, torch.from_numpy(embeds), torch.from_numpy(ids),
                               torch.from_numpy(mask), None, itm_chunks=5)
    with pytest.raises(ValueError, match="must divide"):
        jb.blip2_stage1_losses(jax.tree_util.tree_map(jnp.asarray, setup[0]), JCFG,
                               jnp.asarray(embeds), jnp.asarray(ids), jnp.asarray(mask),
                               jax.random.PRNGKey(0), itm_chunks=5)


def test_sample_negatives_never_picks_the_diagonal():
    w = torch.softmax(torch.randn(6, 6, generator=torch.Generator().manual_seed(0)), -1) + 1e-4
    w = torch.where(torch.eye(6, dtype=torch.bool), 0.0, w)
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        img, txt = tb.sample_negatives(w, w.T.contiguous(), gen)
        assert (img != torch.arange(6)).all() and (txt != torch.arange(6)).all()


@pytest.mark.parametrize("max_length,min_length", [(12, 5), (8, 1)])
def test_generate_caption_token_equal(setup, max_length, min_length):
    jparams, tparams, embeds, _, _ = setup
    # a SEP-heavy decoder bias makes lanes finish early, so the min_length
    # mask and the lanes held at SEP both act
    jparams = dict(jparams, qformer=dict(jparams["qformer"]))
    bias = np.zeros(128, np.float32)
    bias[102] = 1.5
    jparams["qformer"]["cls"] = dict(jparams["qformer"]["cls"], decoder_bias=jnp.asarray(bias))
    tparams = dict(tparams, qformer=dict(tparams["qformer"]))
    tparams["qformer"]["cls"] = dict(tparams["qformer"]["cls"],
                                     decoder_bias=torch.from_numpy(bias))
    want = np.asarray(jax.jit(lambda p, e: jb.blip2_generate_caption(
        p, JCFG, e, max_length=max_length, min_length=min_length))(jparams, jnp.asarray(embeds)))
    got = tb.blip2_generate_caption(tparams, TCFG, torch.from_numpy(embeds),
                                    max_length=max_length, min_length=min_length)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    sep = want == 102
    assert sep.any(), "no lane reached SEP: the test exercises nothing"
    first = np.where(sep.any(1), sep.argmax(1), max_length)
    assert (first >= min(min_length, max_length)).all()
