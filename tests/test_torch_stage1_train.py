"""The stage-1 train steps of the PyTorch port (train/steps.py
``make_stage1_train_step`` and ``make_stage1_raw_train_step``) against the
JAX package: the same weights (bridge.blip2,
bridge.biovil_t), the same numpy batches, the same hard negatives (the
port's ``sample_negatives`` replaced by JAX's categorical draws with each
step's key) and, with ``augment``, the same augmentation draws (the port's
``augment_draws`` replaced by the values JAX draws from the step's key).
FP32 policy, a 2-layer TINY_QFORMER and a (1,1,1,1) basic-block trunk at 64
px (4 patch tokens).

Tolerances: losses rtol = atol = 1e-5 at every step; every parameter
within 2e-6 of JAX's after each of three AdamW steps at lr 1e-3 with Adam's
eps at 1e-3. With the default eps (1e-8) Adam turns a gradient entry that
is only rounding noise (~1e-9: the attention key biases, whose gradient is
0 in exact arithmetic, and a few entries of other leaves) into a step of up
to about lr, in a direction the noise picks; with eps at 1e-3 such an
entry moves by about its gradient, while every entry larger than 1e-3 still
takes Adam's normalized step (the optimizer itself is held against optax
in test_torch_train.py). The augmented step: test_torch_stage1_augment.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.models import biovil_t as jvis
from radialog_tpu.models import blip2 as jb
from radialog_tpu.models import qformer as jq
from radialog_tpu.ops import augment as ja
from radialog_tpu.train import optim as joptim
from radialog_tpu.train import steps as jsteps
from radialog_tpu_torch import bridge
from radialog_tpu_torch.models import blip2 as tb
from radialog_tpu_torch.models import qformer as tq
from radialog_tpu_torch.ops import augment as ta
from radialog_tpu_torch.train import optim as toptim
from radialog_tpu_torch.train import steps as tsteps

LR, EPS, STEPS, B, T = 1e-3, 1e-3, 3, 4, 10
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = 2e-6


def two_layers(q):
    return dataclasses.replace(q, bert=dataclasses.replace(q.bert, num_layers=2))


JCFG = jb.Blip2Config(qformer=two_layers(jq.TINY_QFORMER), max_txt_len=16)
TCFG = tb.Blip2Config(qformer=two_layers(tq.TINY_QFORMER), max_txt_len=16)
KEYS = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in flat(x, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jparams, _ = jb.blip2_init(jax.random.PRNGKey(5), JCFG, with_vision=False)
    vis, vstate = jvis.biovil_t_init(jax.random.PRNGKey(6), joint_feature_size=48,
                                     resnet_layers=(1, 1, 1, 1), bottleneck=False)
    tparams, _ = bridge.blip2(as_np(jparams), {}, device="cpu")
    tvis, tvstate = bridge.biovil_t(as_np(vis), as_np(vstate), device="cpu")
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (STEPS, B, 64, 64), dtype=np.uint8)
    ids = rng.integers(4, 110, (STEPS, B, T)).astype(np.int32)
    ids[:, :, 0] = 101
    mask = np.ones((STEPS, B, T), np.int32)
    for row, n in enumerate([10, 6, 8, 4]):
        ids[:, row, n:] = 0
        mask[:, row, n:] = 0
    embeds = rng.normal(size=(STEPS, B, 5, 48)).astype(np.float32)
    return jparams, tparams, (vis, vstate), (tvis, tvstate), u8, ids, mask, embeds


class JaxNegatives:
    """Stands in for the port's sample_negatives: step i draws what JAX's
    categorical draws with ``keys[i]``."""

    def __init__(self, keys):
        self.keys = list(keys)

    def __call__(self, w_t2i, w_i2t, gen):
        k1, k2 = jax.random.split(self.keys.pop(0))
        draw = [jax.random.categorical(k, jnp.log(jnp.asarray(w.numpy())))
                for k, w in ((k1, w_t2i), (k2, w_i2t))]
        return tuple(torch.from_numpy(np.asarray(d)).long() for d in draw)


def jax_augment_draws(key, n):
    """The values JAX's augment_cxr_batch draws from ``key`` for n images,
    in the port's augment_draws layout."""
    out = {k: [] for k in ("angle", "shear", "brightness", "contrast", "brightness_first")}
    for k in jax.random.split(key, n):
        ka, kj = jax.random.split(k)
        angle, shear = ja.affine_params(ka)
        kb, kc, ko = jax.random.split(kj, 3)
        out["angle"].append(float(angle))
        out["shear"].append(float(shear))
        out["brightness"].append(float(jax.random.uniform(kb, (), minval=0.8, maxval=1.2)))
        out["contrast"].append(float(jax.random.uniform(kc, (), minval=0.8, maxval=1.2)))
        out["brightness_first"].append(bool(jax.random.bernoulli(ko)))
    return {k: torch.tensor(v) for k, v in out.items()}


def _compare(tstate, jstate, tm, jm, step):
    for name in ("loss", "loss_itc", "loss_itm", "loss_lm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), **LOSS_TOL,
                                   err_msg=f"step {step} {name}")
    jf, tf = flat(jstate.params), flat(tstate.params)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        np.testing.assert_allclose(tf[k], jf[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"step {step} {k}")


def test_stage1_step_three_steps(setup, monkeypatch):
    jparams, tparams, _, _, _, ids, mask, embeds = setup
    monkeypatch.setattr(tb, "sample_negatives", JaxNegatives(KEYS))
    jtx = joptim.make_adamw(LR, weight_decay=0.05, eps=EPS)
    ttx = toptim.make_adamw(LR, weight_decay=0.05, eps=EPS)
    jstep = jax.jit(jsteps.make_stage1_train_step(jtx, JCFG))
    tstep = tsteps.make_stage1_train_step(ttx, TCFG)
    js, ts = jsteps.TrainState.create(jparams, jtx), tsteps.TrainState.create(tparams, ttx)
    for i in range(STEPS):
        batch = {"image_embeds": embeds[i], "text_ids": ids[i], "text_mask": mask[i]}
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()}, KEYS[i])
        ts, tm = tstep(ts, batch, None)
        _compare(ts, js, tm, jm, i)
    assert ts.step == STEPS and ts.opt_state["count"] == STEPS


def _raw_run(setup, monkeypatch, augment):
    """STEPS steps of both raw steps; JAX gets uint8 batches. Returns the
    JAX (state, metrics) per step and a function running the port's steps
    on uint8 or f32 images."""
    jparams, tparams, (vis, vstate), (tvis, tvstate), u8, ids, mask, _ = setup
    jtx = joptim.make_adamw(LR, weight_decay=0.05, eps=EPS)
    jstep = jax.jit(jsteps.make_stage1_raw_train_step(jtx, JCFG, augment=augment))
    js = jsteps.TrainState.create(jparams, jtx)
    want = []
    for i in range(STEPS):
        batch = {"images": jnp.asarray(u8[i]), "text_ids": jnp.asarray(ids[i]),
                 "text_mask": jnp.asarray(mask[i])}
        js, jm = jstep(js, vis, vstate, batch, KEYS[i])
        want.append((js, jm))

    def port(images_of):
        neg_keys = [jax.random.split(k)[0] for k in KEYS] if augment else KEYS
        monkeypatch.setattr(tb, "sample_negatives", JaxNegatives(neg_keys))
        aug_keys = [jax.random.split(k)[1] for k in KEYS]
        monkeypatch.setattr(ta, "augment_draws",
                            lambda n, gen, *a, **kw: jax_augment_draws(aug_keys.pop(0), n))
        ttx = toptim.make_adamw(LR, weight_decay=0.05, eps=EPS)
        tstep = tsteps.make_stage1_raw_train_step(ttx, TCFG, augment=augment)
        ts = tsteps.TrainState.create(tparams, ttx)
        for i in range(STEPS):
            batch = {"images": images_of(u8[i]), "text_ids": ids[i], "text_mask": mask[i]}
            ts, tm = tstep(ts, tvis, tvstate, batch, None)
            _compare(ts, want[i][0], tm, want[i][1], i)
        return ts

    return port


def test_stage1_raw_step_three_steps_uint8_and_f32(setup, monkeypatch):
    port = _raw_run(setup, monkeypatch, augment=False)
    ts = port(lambda u: u)                                          # uint8 crops
    assert "visual" not in ts.params and "ln_vision" in ts.params
    # the f32 form (u8 / 255, three channels) of the same crops: the same run
    port(lambda u: np.repeat((u.astype(np.float32) / 255.0)[..., None], 3, -1))
