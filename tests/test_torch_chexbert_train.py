"""The CheXbert training path of the PyTorch port against the JAX package:
BERT and CheXbert forwards in train mode, ``chexbert_loss``, three steps of
``make_chexbert_train_step`` (train/chexbert_train.py), Cohen's kappa, and
the ``run_chexbert`` command line (train and label) on the CPU.

Dropout cannot draw jax.random's masks, so both sides get the same masks:
``dropout`` in both packages' models/bert.py and models/chexbert.py (module
attributes) is replaced by one that takes the next mask of a numpy stream,
in call order (embeddings, then each layer's attention and FFN, then the
CLS row), and applies it with the package's own arithmetic (the port's
through ``ops/layers.py apply_dropout_mask``, the function its dropout
applies a drawn mask with). The jitted JAX step takes each step's masks as
arguments, so one trace serves three steps. A tiny BERT (the run_chexbert
mock's: vocab 256, width 32, 2 layers), FP32.

Tolerances: forwards 1e-5 (f32 sums in another order); the loss 1e-6; the
steps' losses 1e-5 relative and every parameter within 2e-6 after each of
three AdamW steps at lr 1e-3, eps 1e-3 (as test_torch_stage1_train.py);
kappas equal.
"""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.models import bert as jbert
from radialog_tpu.models import chexbert as jcb
from radialog_tpu.train import chexbert_train as jct
from radialog_tpu.train import optim as joptim
from radialog_tpu.train import steps as jsteps
from radialog_tpu_torch import bridge
from radialog_tpu_torch.apps import run_chexbert as tapp
from radialog_tpu_torch.models import bert as tbert
from radialog_tpu_torch.models import chexbert as tcb
from radialog_tpu_torch.ops import layers as tl
from radialog_tpu_torch.train import chexbert_train as tct
from radialog_tpu_torch.train import optim as toptim
from radialog_tpu_torch.train import steps as tsteps
from test_torch_stage1_train import flat

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
LR, EPS, STEPS, B, T = 1e-3, 1e-3, 3, 4, 12
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = 2e-6
JCFG = jbert.BertConfig(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
                        intermediate_size=64, max_position=64)
TCFG = tbert.BertConfig(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
                        intermediate_size=64, max_position=64)


class Masks:
    """The keep-masks of one side: the next mask of x's shape from a numpy
    stream at each call, or the next of ``queue`` where it holds any.
    ``calls`` counts the masks used."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.calls = 0
        self.queue = []

    def next(self, shape, rate):
        self.calls += 1
        return self.queue.pop(0) if self.queue else self.rng.random(shape) < 1.0 - rate


def step_masks(rng, n_layers, rate=0.1):
    """One step's masks in call order: embeddings, each layer's attention
    and FFN outputs (B, T, H), the CLS row (B, H)."""
    return ([rng.random((B, T, TCFG.hidden_size)) < 1.0 - rate for _ in range(2 * n_layers + 1)]
            + [rng.random((B, TCFG.hidden_size)) < 1.0 - rate])


def use_masks(monkeypatch, seed):
    """Both packages' dropout replaced; returns the two mask streams."""
    jm, tm = Masks(seed), Masks(seed)

    def jax_dropout(key, x, rate, train):
        if not train or rate <= 0.0 or key is None:
            return x
        mask = jnp.asarray(jm.next(x.shape, rate))
        return jnp.where(mask, x / (1.0 - rate), 0.0).astype(x.dtype)

    def port_dropout(x, rate, train, gen):
        if not train or rate <= 0.0 or gen is None:
            return x
        return tl.apply_dropout_mask(x, torch.from_numpy(tm.next(tuple(x.shape), rate)), rate)

    for mod in (jbert, jcb):
        monkeypatch.setattr(mod, "dropout", jax_dropout)
    for mod in (tbert, tcb):
        monkeypatch.setattr(mod, "dropout", port_dropout)
    return jm, tm


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    params = jcb.chexbert_init(jax.random.PRNGKey(11), JCFG)
    rng = np.random.default_rng(12)
    ids = rng.integers(4, 250, (STEPS, B, T)).astype(np.int32)
    mask = np.ones((STEPS, B, T), np.int32)
    mask[:, 1, 9:] = 0                                   # a padded row
    labels = np.concatenate([rng.integers(0, 4, (STEPS, B, 13)),
                             rng.integers(0, 2, (STEPS, B, 1))], axis=2).astype(np.int32)
    return params, ids, mask, labels


def test_chexbert_forward_train_mode(model, monkeypatch):
    params, ids, mask, _ = model
    jm, tm = use_masks(monkeypatch, 0)
    ref = jcb.chexbert_apply(params, JCFG, jnp.asarray(ids[0]), jnp.asarray(mask[0]),
                             train=True, key=jax.random.PRNGKey(0))
    got = tcb.chexbert_apply(bridge.chexbert(_np(params), "cpu"), TCFG, torch.from_numpy(ids[0]),
                             torch.from_numpy(mask[0]), train=True,
                             gen=torch.Generator().manual_seed(0))
    assert jm.calls == tm.calls == 2 * TCFG.num_layers + 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **FWD_TOL)
    # bert_apply with masks, and without a generator (no dropout: eval's output)
    jm, tm = use_masks(monkeypatch, 1)
    ref = jbert.bert_apply(params["bert"], JCFG, jnp.asarray(ids[1]), jnp.asarray(mask[1]),
                           train=True, key=jax.random.PRNGKey(1))
    tp = bridge.chexbert(_np(params), "cpu")
    got = tbert.bert_apply(tp["bert"], TCFG, torch.from_numpy(ids[1]), torch.from_numpy(mask[1]),
                           train=True, gen=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    plain = tbert.bert_apply(tp["bert"], TCFG, torch.from_numpy(ids[1]), torch.from_numpy(mask[1]))
    assert torch.equal(plain, tbert.bert_apply(tp["bert"], TCFG, torch.from_numpy(ids[1]),
                                               torch.from_numpy(mask[1]), train=True))


def test_chexbert_loss():
    rng = np.random.default_rng(13)
    logits = [(rng.normal(size=(6, 2 if i == 13 else 4)) * 2).astype(np.float32)
              for i in range(14)]
    labels = np.concatenate([rng.integers(0, 4, (6, 13)), rng.integers(0, 2, (6, 1))], 1)
    ref = jct.chexbert_loss([jnp.asarray(x) for x in logits], jnp.asarray(labels))
    got = tct.chexbert_loss([torch.from_numpy(x) for x in logits], torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def test_chexbert_three_steps(model, monkeypatch):
    params, ids, mask, labels = model
    jm, tm = use_masks(monkeypatch, 2)
    jtx = joptim.make_adamw(LR, weight_decay=0.0, eps=EPS)
    ttx = toptim.make_adamw(LR, weight_decay=0.0, eps=EPS)
    jstep = jct.make_chexbert_train_step(jtx, JCFG)
    tstep = tct.make_chexbert_train_step(ttx, TCFG)

    def with_masks(state, batch, key, masks):      # the masks become the trace's inputs
        jm.queue.extend(masks)
        return jstep(state, batch, key)

    jrun = jax.jit(with_masks)
    js = jsteps.TrainState.create(params, jtx)
    ts = tsteps.TrainState.create(bridge.chexbert(_np(params), "cpu"), ttx)
    gen = torch.Generator().manual_seed(0)
    mrng = np.random.default_rng(3)
    for i in range(STEPS):
        masks = step_masks(mrng, TCFG.num_layers)
        batch = {"input_ids": ids[i], "attention_mask": mask[i], "labels": labels[i]}
        js, jmet = jrun(js, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(20 + i), [jnp.asarray(m) for m in masks])
        tm.queue.extend(masks)
        ts, tmet = tstep(ts, batch, gen)
        assert not jm.queue and not tm.queue
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]), **LOSS_TOL,
                                   err_msg=f"step {i}")
        jf, tf = flat(js.params), flat(ts.params)
        assert sorted(jf) == sorted(tf)
        for k in jf:
            np.testing.assert_allclose(tf[k], jf[k], rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"step {i} {k}")
    assert jm.calls == 2 * TCFG.num_layers + 2                 # traced once
    assert tm.calls == STEPS * (2 * TCFG.num_layers + 2)
    assert ts.step == STEPS and ts.opt_state["count"] == STEPS


def test_kappa():
    rng = np.random.default_rng(14)
    cases = [(rng.integers(0, 4, 50), rng.integers(0, 4, 50)),
             (np.ones(7, int), np.ones(7, int)),               # agreement by chance 1
             (np.zeros(0, int), np.zeros(0, int)),
             (np.array([0, 1, 2, 3]), np.array([3, 2, 1, 0]))]
    for a, b in cases:
        assert tct.cohens_kappa(a, b) == jct.cohens_kappa(a, b)
    labels = rng.integers(0, 4, (40, 14))
    preds = np.where(rng.random((40, 14)) < 0.6, labels, rng.integers(0, 4, (40, 14)))
    assert tct.mean_kappa(labels, preds) == jct.mean_kappa(labels, preds)


def test_run_chexbert_cli_on_cpu(tmp_path, capsys):
    """``train --mock`` prints the kappa line every second step and keeps
    both checkpoints; ``label --mock`` writes the labels CSV of every report
    (the JAX labeler's header, one row a report)."""
    tapp.main(["train", "--mock", "--device", "cpu", "--output_dir", str(tmp_path / "ck")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["step 1", "step 3", "step 5"]
    assert all("loss=" in ln and "kappa=" in ln and "best=" in ln for ln in lines)
    assert lines[0].endswith("best=True")
    for name in ("best", "last"):
        assert (tmp_path / "ck" / name / "tree.pt").exists()
    reports = [f"the lungs are clear, study {i}. no effusion" for i in range(5)]
    with open(tmp_path / "r.csv", "w", newline="") as f:
        csv.writer(f).writerows([r] for r in reports)
    out = tmp_path / "labels.csv"
    tapp.main(["label", "--reports_path", str(tmp_path / "r.csv"), "--output_path", str(out),
               "--mock", "--device", "cpu", "--batch_size", "2"])
    assert capsys.readouterr().out.strip() == f"labeled 5 reports -> {out}"
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["findings"] + list(tcb.CHEXBERT_CONDITIONS)
    assert [r[0] for r in rows[1:]] == reports
    assert all(v in ("", "1.0", "0.0", "-1.0") for r in rows[1:] for v in r[1:])
    with pytest.raises(SystemExit):
        tapp.main(["train", "--device", "cpu"])
