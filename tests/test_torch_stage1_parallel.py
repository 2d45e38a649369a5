"""Stage 1's global-batch ITC/ITM/LM across ranks (models/blip2.py
``blip2_stage1_losses(data_group=...)``, parallel/collectives.py
``gather_batch``, train/steps.py ``make_stage1_train_step(data_group=...)``)
against the JAX package's ``blip2_stage1_losses`` and an SGD step of its
gradient on the whole batch: the counterpart of tests/
test_stage1_multichip.py, whose claim is that the sharded step computes
the global-batch losses.

Two gloo rank processes (tests/torch_tp_ranks.py) on a (2, 1) mesh, each
holding 4 of the 8 rows. The hard negatives are JAX's own draws with the
loss's key (``jax.random.categorical``, which a ``torch.Generator`` cannot
give), found once on the whole batch and handed to both ranks in place of
``sample_negatives``, as tests/test_torch_stage1_model.py hands them to the
one-process loss. Rows of different text lengths, so the ranks hold
different counts of LM tokens.

Tolerances, tests/test_stage1_multichip.py's: the four losses within 1e-5,
the updated params within 2e-5 (SGD, learning rate 0.1, f32 sums in
another order). The ITC loss of either half alone parts from the global
one by far more: the negatives of the other ranks count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.models import blip2 as jb
from radialog_tpu.models import qformer as jq
from radialog_tpu_torch import bridge
from radialog_tpu_torch.models import blip2 as tb
from radialog_tpu_torch.models import qformer as tq

import torch_tp_ranks
from test_torch_stage1_model import flat, jax_negatives, two_layers

B, N, T, LR = 8, 6, 10, 0.1
JCFG = jb.Blip2Config(qformer=two_layers(jq.TINY_QFORMER), embed_dim=16, max_txt_len=12)
TCFG = tb.Blip2Config(qformer=two_layers(tq.TINY_QFORMER), embed_dim=16, max_txt_len=12)
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def setup():
    jparams, _ = jb.blip2_init(jax.random.PRNGKey(1), JCFG, with_vision=False)
    jparams["temp"] = jnp.asarray(0.09, jnp.float32)
    tparams, _ = bridge.blip2(jax.tree_util.tree_map(np.asarray, jparams), {}, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"image_embeds": rng.normal(size=(B, N, 48)).astype(np.float32),
             "text_ids": rng.integers(4, 110, (B, T)).astype(np.int32),
             "text_mask": np.ones((B, T), np.int32)}
    batch["text_ids"][:, 0] = 101
    for row, n in enumerate([10, 9, 8, 10, 4, 3, 5, 4]):
        batch["text_ids"][row, n:] = 0
        batch["text_mask"][row, n:] = 0
    key = jax.random.PRNGKey(3)

    # JAX's draws on the whole batch, as its loss makes them
    drawn = []
    draw = jax_negatives(key)

    def keep(w_t2i, w_i2t, gen):
        drawn.append(draw(w_t2i, w_i2t, gen))
        return drawn[-1]
    real = tb.sample_negatives
    tb.sample_negatives = keep
    try:
        with torch.no_grad():
            tb.blip2_stage1_losses(tparams, TCFG, *(torch.from_numpy(batch[k]) for k in
                                                    ("image_embeds", "text_ids", "text_mask")),
                                   None)
    finally:
        tb.sample_negatives = real
    negatives = tuple(x.numpy() for x in drawn[0])

    def loss_fn(p):
        out = jb.blip2_stage1_losses(p, JCFG, *(jnp.asarray(batch[k]) for k in
                                                ("image_embeds", "text_ids", "text_mask")), key)
        return out.loss, out
    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    updated = jax.tree_util.tree_map(lambda p, g: p - LR * g, jparams, grads)
    return tparams, batch, negatives, key, out, flat(updated)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    tparams, batch, negatives, _, _, _ = setup
    case = dict(stage1=True, mesh=(2, 1), cfg=dict(qformer=TCFG.qformer, embed_dim=16,
                                                   max_txt_len=12),
                params=tparams, batch=batch, negatives=negatives)
    return torch_tp_ranks.run_ranks({"kind": "train", "lr": LR, "cases": {"stage1": case}}, 2,
                                    tmp_path_factory.mktemp("stage1"))


def test_losses_are_the_global_batch_s(setup, ranks):
    _, _, _, _, jout, _ = setup
    for out in ranks:
        for name in ("loss", "loss_itc", "loss_itm", "loss_lm"):
            np.testing.assert_allclose(out["stage1"]["metrics"][name],
                                       float(getattr(jout, name)), **TOL, err_msg=name)
        assert not out["jax_imported"]


def test_sgd_step_matches_the_whole_batch_gradient(setup, ranks):
    want = setup[5]
    for out in ranks:
        got = {"/" + k: v for k, v in out["stage1"]["params"].items()}
        assert sorted(got) == sorted(want) and len(got) > 50
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **PARAM_TOL, err_msg=k)
    for k, v in ranks[0]["stage1"]["params"].items():       # the ranks agree bitwise
        np.testing.assert_array_equal(v, ranks[1]["stage1"]["params"][k], err_msg=k)


def test_half_batch_itc_differs(setup):
    """Each half's in-batch ITC (its own 4 negatives a row) is another
    number than the global one: the gathered columns matter."""
    tparams, batch, negatives, _, jout, _ = setup
    for half in (slice(0, 4), slice(4, 8)):
        picked = (torch.tensor([0, 1, 2, 3]), torch.tensor([1, 0, 3, 2]))
        real = tb.sample_negatives
        tb.sample_negatives = lambda w_t2i, w_i2t, gen: picked
        try:
            with torch.no_grad():
                out = tb.blip2_stage1_losses(
                    tparams, TCFG, *(torch.from_numpy(batch[k][half]) for k in
                                     ("image_embeds", "text_ids", "text_mask")), None)
        finally:
            tb.sample_negatives = real
        assert abs(float(out.loss_itc) - float(jout.loss_itc)) > 1e-2
