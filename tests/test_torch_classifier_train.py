"""The findings-classifier training path of the PyTorch port against the JAX
package: train-mode BatchNorm, dropout and the init draws
(ops/layers.py), the ResNet, BioViL-T and classifier forwards in train mode,
the loss, the metric helpers, three train steps (train/classifier.py), the
structured-predictions JSON, ``summarize`` and the ``chexpert_train``
command line on the CPU. Weights through the bridge, FP32, a (1,1,1,1)
basic-block trunk: at 64 px for the forwards, at the classifier's 488 px
(fc1 reads 128 x 4 x 4) for the steps.

Tolerances. Train-mode BatchNorm: y and the new state within 1e-5 (relative
and absolute; f32 sums in another order). Forwards: 1e-4, as
test_torch_vision.py holds eval mode. Steps (AdamW lr 1e-4, the CLI's
order of magnitude, eps 1e-3; one image a batch, the batch axis being held
by the forwards at 3): ``STEP_TOL``, 5-8x the spread measured here with 1,
3 and 8 torch threads, plain and augmented alike: losses within 2.1e-7
relative, 99 % of all parameter entries within 1.2e-7, every entry within
4.9e-6, running means within 9.7e-6 and variances 4.5e-6. The spread is
the f32 gradient's own: a ReLU input within ~1e-5 of 0 takes the other side
under another sum order, which flips its entry's gradient, and the
BatchNorms spread that over their channels (at batch 2 the largest entry
reached 0.65 x lr at lr 1e-3). A BatchNorm backward of the wrong sign or
scale, or a lost unbiased factor, moves entries and stats far past these
bars. Augmented images can also sample across a rounding tie of the two
sides' f32 sin, cos and tan (test_torch_stage1_augment.py); none of these
three batches does.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.models import biovil_t as jb
from radialog_tpu.models import chexpert as jc
from radialog_tpu.ops import augment as ja
from radialog_tpu.ops import layers as jl
from radialog_tpu.train import classifier as jcl
from radialog_tpu.train import optim as joptim
from radialog_tpu.train import steps as jsteps
from radialog_tpu.utils import summary as jsum
from radialog_tpu_torch import bridge
from radialog_tpu_torch.apps import chexpert_train as tapp
from radialog_tpu_torch.models import biovil_t as tb
from radialog_tpu_torch.models import chexpert as tc
from radialog_tpu_torch.models import resnet as tr
from radialog_tpu_torch.ops import augment as ta
from radialog_tpu_torch.ops import layers as tl
from radialog_tpu_torch.train import classifier as tcl
from radialog_tpu_torch.train import optim as toptim
from radialog_tpu_torch.train import steps as tsteps
from radialog_tpu_torch.utils import summary as tsum
from test_torch_stage1_train import flat, jax_augment_draws

BN_TOL = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
LR, EPS, STEPS, B = 1e-4, 1e-3, 3, 1
# the loss (relative), the 99th percentile and the largest of the parameters'
# differences, the running stats' (absolute; counts equal)
STEP_TOL = {"loss": 1e-6, "q99": 1e-6, "max": 0.2 * LR, "mean": 5e-5, "var": 3e-5,
            "count": 0.0}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("shape", [(2, 5, 7, 6), (3, 16), (4, 3, 3, 4, 8)])
def test_batchnorm_train_mode(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    p = {"scale": rng.normal(size=c).astype(np.float32),
         "bias": rng.normal(size=c).astype(np.float32)}
    s = {"mean": rng.normal(size=c).astype(np.float32),
         "var": rng.random(c).astype(np.float32) + 0.5, "count": np.float32(3.0)}
    ref, ref_s = jl.batchnorm(p, s, jnp.asarray(x), train=True, momentum=0.2)
    got, got_s = tl.batchnorm(bridge.to_torch(p, "cpu"), bridge.to_torch(s, "cpu"),
                              torch.from_numpy(x), train=True, momentum=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **BN_TOL)
    assert sorted(got_s) == sorted(ref_s)
    for k in ref_s:
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(ref_s[k]), **BN_TOL)
    assert not got_s["mean"].requires_grad
    # eval mode keeps its one-tensor return and reads the running stats
    ev = tl.batchnorm(bridge.to_torch(p, "cpu"), bridge.to_torch(s, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(ev.numpy(), np.asarray(jl.batchnorm(p, s, jnp.asarray(x))[0]),
                               **BN_TOL)


def test_div_scalar_is_an_ieee_division_in_the_input_dtype():
    """ops/layers.py div_scalar (dropout's division by 1 - rate) is numpy's
    division for f32, f64 and bf16 inputs, and keeps the input dtype."""
    x = torch.randn(3, 7, 768, generator=torch.Generator().manual_seed(0)) * 3 + 1
    for value in (0.9, 0.5, 3.0, 1.0 - 0.1):
        np.testing.assert_array_equal(tl.div_scalar(x, value).numpy(),
                                      x.numpy() / np.float32(value))
        np.testing.assert_array_equal(tl.div_scalar(x.double(), value).numpy(),
                                      x.double().numpy() / value)
        got = tl.div_scalar(x.bfloat16(), value)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, x.bfloat16() / torch.tensor(value, dtype=torch.bfloat16))


def test_dropout():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(200_000, generator=gen) + 3.0
    for train, rate, g in ((False, 0.1, gen), (True, 0.0, gen), (True, 0.1, None)):
        assert tl.dropout(x, rate, train, g) is x
    y = tl.dropout(x, 0.1, True, torch.Generator().manual_seed(1))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 4e-3      # 6 sigma of 200,000 draws
    # kept entries divided by 0.9 as numpy divides (an IEEE division)
    np.testing.assert_array_equal(y[kept].numpy(), x[kept].numpy() / np.float32(0.9))
    # the same generator state draws the same mask; bf16 stays bf16
    assert torch.equal(y, tl.dropout(x, 0.1, True, torch.Generator().manual_seed(1)))
    assert tl.dropout(x.bfloat16(), 0.5, True, gen).dtype == torch.bfloat16


def test_init_draws():
    gen = torch.Generator().manual_seed(0)
    t = tl.trunc_normal(gen, (300, 200), std=0.5)
    assert t.shape == (300, 200) and t.dtype == torch.float32
    assert t.abs().max().item() < 1.0                         # inside (-2 std, 2 std)
    assert abs(t.std().item() - 0.5 * 0.8796) < 0.01          # truncated at 2 sigma
    n = tl.normal_init(gen, (400, 300), std=2.0, dtype=torch.bfloat16)
    assert n.dtype == torch.bfloat16 and abs(n.float().std().item() - 2.0) < 0.02
    # trunc_normal's and normal_init's JAX namesakes draw the same distributions
    jt = np.asarray(jl.trunc_normal(jax.random.PRNGKey(0), (300, 200), std=0.5))
    assert abs(jt.std() - t.std().item()) < 0.01


# ---------------------------------------------------------------- forwards
def test_resnet_and_biovil_train_mode():
    """BioViL-T in train mode, bottleneck blocks (the basic ones run in the
    classifier's steps), batch 3: the outputs and the new state of every
    BatchNorm, the ResNet's included; the port's resnet_apply alone gives
    the trunk's part of that state."""
    params, state = jb.biovil_t_init(jax.random.PRNGKey(4), joint_feature_size=48,
                                     resnet_layers=(1, 1, 1, 1), bottleneck=True)
    tp, ts = bridge.biovil_t(_np(params), _np(state), device="cpu")
    x = np.random.default_rng(5).random((3, 64, 64, 3)).astype(np.float32)
    ref, ref_s = jax.jit(functools.partial(jb.biovil_t_apply, train=True))(
        params, state, jnp.asarray(x))
    got, got_s = tb.biovil_t_apply(tp, ts, torch.from_numpy(x), train=True)
    for name in ref._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   **FWD_TOL)
    _close_trees(flat(got_s), flat(ref_s), FWD_TOL)
    _, trunk_s = tr.resnet_apply(tp["resnet"], ts["resnet"], torch.from_numpy(x), train=True)
    _close_trees(flat(trunk_s), flat(got_s["resnet"]), dict(rtol=0, atol=0))


def _close_trees(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


def test_loss_and_metric_helpers():
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(5, 14)) * 3).astype(np.float32)
    targets = rng.integers(0, 2, (5, 14)).astype(np.float32)
    pw = jcl.class_weights(rng.integers(0, 2, (20, 14)), "log")
    for w in (None, pw):
        ref = jc.bce_with_logits_loss(jnp.asarray(logits), jnp.asarray(targets),
                                      None if w is None else jnp.asarray(w))
        got = tc.bce_with_logits_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                      None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    labels = rng.integers(0, 2, (30, 14))
    labels[:, 3] = 0                                          # a class with no positive
    for how in ("none", "lin", "log"):
        np.testing.assert_array_equal(tcl.class_weights(labels, how),
                                      jcl.class_weights(labels, how))
    with pytest.raises(ValueError):
        tcl.class_weights(labels, "sqrt")
    probs = rng.random((30, 14))
    assert tcl.multilabel_f1(labels, probs) == jcl.multilabel_f1(labels, probs)
    row = probs[0] > 0.5
    assert tc.findings_to_text(row) == jc.findings_to_text(row)


# ------------------------------------------------------------------- steps
@pytest.fixture(scope="module")
def classifier():
    k = jax.random.split(jax.random.PRNGKey(3), 3)
    params = {}
    params["biovil"], state = jb.biovil_t_init(k[0], joint_feature_size=128,
                                               resnet_layers=(1, 1, 1, 1), bottleneck=False)
    params["fc1"] = jl.linear_init(k[1], 128 * 4 * 4, 512)
    params["fc2"] = jl.linear_init(k[2], 512, jc.NUM_CLASSES)
    state = {"biovil": state}
    rng = np.random.default_rng(7)
    crop = jc.CLASSIFIER_CROP
    images = rng.random((STEPS, B, crop, crop, 3)).astype(np.float32)
    labels = rng.integers(0, 2, (STEPS, B, jc.NUM_CLASSES)).astype(np.float32)
    pw = jcl.class_weights(rng.integers(0, 2, (16, jc.NUM_CLASSES)), "log")
    return params, state, images, labels, pw


@pytest.fixture(scope="module")
def jax_step(classifier):
    """The JAX plain step, jitted once for both cases, and its optimizer."""
    jtx = joptim.make_adamw(LR, weight_decay=0.0, eps=EPS)
    return jtx, jax.jit(jcl.make_classifier_train_step(jtx, classifier[4]))


def _jax_augment(images, key):
    """What JAX's augmented step does to its batch before the update
    (train/classifier.py: a key per image, vmapped augment_cxr)."""
    return jax.vmap(ja.augment_cxr)(images, jax.random.split(key, images.shape[0]))


@pytest.mark.parametrize("augment", [False, True])
def test_classifier_three_steps(classifier, jax_step, augment, monkeypatch):
    """Three steps of both step makers from the same weights and batches;
    augmented, the JAX side's batch goes through the augmentation its
    augmented step applies, and the port's draws are JAX's for each step's
    key."""
    params, state, images, labels, pw = classifier
    keys = [jax.random.PRNGKey(200 + i) for i in range(STEPS)]
    jtx, jstep = jax_step
    js, jms = jsteps.TrainState.create(params, jtx), state
    tp, tms = bridge.chexpert(_np(params), _np(state), device="cpu")
    ttx = toptim.make_adamw(LR, weight_decay=0.0, eps=EPS)
    tstep = tcl.make_classifier_train_step(ttx, pw, augment=augment)
    ts = tsteps.TrainState.create(tp, ttx)
    aug_keys = list(keys)
    monkeypatch.setattr(ta, "augment_draws",
                        lambda n, gen, *a, **kw: jax_augment_draws(aug_keys.pop(0), n))
    for i in range(STEPS):
        jimages = jnp.asarray(images[i])
        if augment:
            jimages = jax.jit(_jax_augment)(jimages, keys[i])
        js, jms, jm = jstep(js, jms, {"images": jimages, "labels": jnp.asarray(labels[i])})
        ts, tms, tm = tstep(ts, tms, {"images": images[i], "labels": labels[i]})
        bar = STEP_TOL
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=bar["loss"],
                                   err_msg=f"step {i}")
        jf, tf = flat(js.params), flat(ts.params)
        assert sorted(jf) == sorted(tf)
        diff = np.concatenate([np.abs(tf[k] - jf[k]).ravel() for k in jf])
        assert np.quantile(diff, 0.99) <= bar["q99"], (i, np.quantile(diff, 0.99))
        assert diff.max() <= bar["max"], (i, diff.max())
        jsf, tsf = flat(jms), flat(tms)
        assert sorted(jsf) == sorted(tsf)
        for k in jsf:
            np.testing.assert_allclose(tsf[k], jsf[k], rtol=0,
                                       atol=bar[k.rsplit("/", 1)[1]], err_msg=f"{i} {k}")
    assert ts.step == STEPS and len(aug_keys) == (0 if augment else STEPS)


def test_save_structured_predictions_bytes(tmp_path):
    rng = np.random.default_rng(8)
    probs = [rng.random((4, 14)) for _ in range(3)]
    ids = [[f"d{j}{i}" for i in range(4)] for j in range(3)]
    jcl.save_structured_predictions(lambda p: p, zip(ids, probs), tmp_path / "j.json")
    out = tcl.save_structured_predictions(lambda p: torch.from_numpy(p), zip(ids, probs),
                                          tmp_path / "t.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert len(out) == 12


def test_summarize_strings(classifier):
    params, state = classifier[:2]
    tp, _ = bridge.chexpert(_np(params), _np(state), device="cpu")
    # the bridge's tree has jax.tree_util's sorted key order; summarize walks
    # a dict in its own order
    params = jax.tree_util.tree_map(lambda a: a, params)
    for depth in (1, 3):
        assert tsum.summarize(tp, depth) == jsum.summarize(params, depth)
    assert tsum.param_count(tp) == jsum.param_count(params)
    assert tsum.param_bytes(tp) == jsum.param_bytes(params)
    half = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params["fc1"])
    assert tsum.summarize(bridge.to_torch(_np(half), "cpu"), 1, "fc1") == \
        jsum.summarize(half, 1, "fc1")


def test_chexpert_train_cli_on_cpu(tmp_path, monkeypatch, capsys):
    """The command line with --device cpu, a (1,1,1,1) basic trunk in place
    of ResNet-50 for the CPU's time: one JSON line an epoch with the JAX
    CLI's keys, both checkpoints and the structured predictions."""
    monkeypatch.setattr(tapp, "chexpert_classifier_init",
                        functools.partial(tapp.chexpert_classifier_init,
                                          resnet_layers=(1, 1, 1, 1), bottleneck=False))
    out = tmp_path / "out"
    tapp.main(["--mock", "--epochs", "1", "--steps", "1", "--train", "--save_preds",
               "--device", "cpu", "--output_dir", str(out), "--run_name", "t"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("class weights (first 4):")
    epoch = json.loads(lines[1])
    assert sorted(epoch) == ["epoch", "loss", "val_acc", "val_f1"] and epoch["epoch"] == 0
    assert np.isfinite(epoch["loss"])
    assert lines[2] == f"wrote 8 structured predictions -> {out}/structured_preds_t.json"
    preds = json.loads((out / "structured_preds_t.json").read_text())
    assert sorted(preds) == [f"dcm{i:03d}" for i in range(8)]
    assert all(set(v) <= set(tc.CHEXPERT_CLASSES) for v in preds.values())
    for name in ("best", "last"):
        assert (out / name / "tree.pt").exists() and (out / f"{name}.meta.json").exists()
    with pytest.raises(SystemExit):
        tapp.main(["--device", "cpu"])
