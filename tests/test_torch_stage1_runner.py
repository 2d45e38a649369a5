"""The stage-1 runner of the PyTorch port (train/runner.py: Stage1Runner's
train, train_iters, validate and dump_val_generations, generate_html_table,
precompute_embeddings) and utils/logging.py against the JAX package's.

Both runners start from the same weights (bridge.blip2) on the same numpy
batches, with both negative samplers replaced by one fixed choice (each
row's negative is the next row), so the runs differ only in arithmetic.
Stage1Config's defaults give a learning rate near 1e-6 over these few
steps. Tolerances: each step's four losses and the log's numbers
rtol = atol = 1e-5; the prediction and ground-truth files byte-equal; the
log's keys equal; the embeddings' npz rtol = atol = 1e-5 under the same
keys. A 2-layer TINY_QFORMER keeps the JAX compiles short.
"""
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.models import blip2 as jb
from radialog_tpu.models import qformer as jq
from radialog_tpu.train import runner as jr
from radialog_tpu.utils import logging as jlog
from radialog_tpu_torch import bridge
from radialog_tpu_torch.models import blip2 as tb
from radialog_tpu_torch.models import qformer as tq
from radialog_tpu_torch.train import runner as tr
from radialog_tpu_torch.utils import logging as tlog

TOL = dict(rtol=1e-5, atol=1e-5)
B, SPE = 4, 2


def two_layers(q):
    return dataclasses.replace(q, bert=dataclasses.replace(q.bert, num_layers=2))


JCFG = jb.Blip2Config(qformer=two_layers(jq.TINY_QFORMER), max_txt_len=16)
TCFG = tb.Blip2Config(qformer=two_layers(tq.TINY_QFORMER), max_txt_len=16)


def fixed_negatives(monkeypatch):
    """Row i's negative image and text are row i + 1 (mod B), in both packages."""
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits: (jnp.arange(logits.shape[0]) + 1) % logits.shape[0])

    def port(w_t2i, w_i2t, gen):
        idx = (torch.arange(w_t2i.shape[0]) + 1) % w_t2i.shape[0]
        return idx, idx
    monkeypatch.setattr(tb, "sample_negatives", port)


def batches_from(seed):
    def batches(sub=0):
        rng = np.random.default_rng(seed + 10 * sub)
        for _ in range(SPE):
            ids = rng.integers(4, 110, (B, 12)).astype(np.int32)
            ids[:, 0] = 101
            mask = np.ones((B, 12), np.int32)
            mask[1, 9:] = 0
            ids[1, 9:] = 0
            yield {"image_embeds": rng.normal(size=(B, 5, 48)).astype(np.float32),
                   "text_ids": ids, "text_mask": mask}
    return batches


def decode(row):
    return " ".join(f"t{int(i)}" for i in row if int(i) > 3)


def recording(runner, log):
    """Wrap the runner's step so that each step's metrics are kept."""
    step = runner.step_fn

    def wrapped(*a):
        state, metrics = step(*a)
        log.append({k: float(v) for k, v in metrics.items()})
        return state, metrics
    runner.step_fn = wrapped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    fixed_negatives(mp)
    try:
        jparams, _ = jb.blip2_init(jax.random.PRNGKey(4), JCFG, with_vision=False)
        tparams, _ = bridge.blip2(jax.tree_util.tree_map(np.asarray, jparams), {}, "cpu")
        out = {}
        for name, mod, cfg, params, eval_fn, gen_fn in (
            ("jax", jr, JCFG, jparams,
             jax.jit(lambda p, b, rng: jb.blip2_stage1_losses(
                 p, JCFG, b["image_embeds"], b["text_ids"], b["text_mask"], rng).loss),
             jax.jit(lambda p, b: jb.blip2_generate_caption(p, JCFG, b["image_embeds"],
                                                            max_length=8, min_length=1))),
            ("port", tr, TCFG, tparams,
             lambda p, b, gen: tb.blip2_stage1_losses(
                 p, TCFG, torch.as_tensor(b["image_embeds"]), torch.as_tensor(b["text_ids"]),
                 torch.as_tensor(b["text_mask"]), gen).loss.detach(),
             lambda p, b: tb.blip2_generate_caption(p, TCFG, torch.as_tensor(b["image_embeds"]),
                                                    max_length=8, min_length=1))):
            d = tmp_path_factory.mktemp(name)
            scfg = mod.Stage1Config(max_epoch=2, output_dir=str(d), log_freq=1)
            runner = mod.Stage1Runner(scfg, cfg, params, steps_per_epoch=SPE)
            steps = []
            recording(runner, steps)
            runner.train(batches_from(0), val_batches=lambda: batches_from(99)(),
                         eval_fn=eval_fn, generate_fn=gen_fn, decode_fn=decode)
            n_train = len(steps)
            runner.train_iters(batches_from(7)(), iters_per_inner_epoch=1, max_iters=2,
                               val_batches=lambda: batches_from(99)(), eval_fn=eval_fn)
            out[name] = {"dir": d, "steps": steps, "n_train": n_train,
                         "val": runner.validate(lambda: batches_from(99)(), eval_fn),
                         "dump": runner.dump_val_generations(3, lambda: batches_from(5)(),
                                                             gen_fn, decode, split_name="x"),
                         "state": runner.state}
        yield out
    finally:
        mp.undo()


def test_runner_losses_of_every_step(runs):
    j, t = runs["jax"], runs["port"]
    assert t["n_train"] == j["n_train"] == 2 * 2 * SPE and len(t["steps"]) == len(j["steps"])
    for a, b in zip(t["steps"], j["steps"]):
        assert sorted(a) == sorted(b) == ["loss", "loss_itc", "loss_itm", "loss_lm"]
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=k)
    np.testing.assert_allclose(t["val"], j["val"], **TOL)
    assert int(t["state"].step) == int(j["state"].step) == len(j["steps"])


def test_runner_log_and_checkpoints(runs):
    lines = {k: [json.loads(x) for x in (runs[k]["dir"] / "log.txt").read_text().splitlines()]
             for k in ("jax", "port")}
    assert [sorted(x) for x in lines["port"]] == [sorted(x) for x in lines["jax"]]
    for a, b in zip(lines["port"], lines["jax"]):
        for k in a:
            if isinstance(a[k], float):
                np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=k)
            else:
                assert a[k] == b[k], k
    for tag in ("best", "last"):
        tm = json.loads((runs["port"]["dir"] / f"{tag}.meta.json").read_text())
        jm = json.loads((runs["jax"]["dir"] / f"{tag}.meta.json").read_text())
        assert tm["step"] == jm["step"]
        np.testing.assert_allclose(tm["metric"], jm["metric"], **TOL)
        assert (runs["port"]["dir"] / tag / "tree.pt").exists()


def test_dump_val_generations_byte_equal(runs):
    for split in ("val", "x"):
        for sub, name in (("predictions", "predictions"), ("ground_truths", "ground_truths")):
            path = f"{sub}/{name}_{split}.txt"
            got = (runs["port"]["dir"] / path).read_bytes()
            assert got == (runs["jax"]["dir"] / path).read_bytes(), path
            assert got.count(b"\n") == 2 * B and got.startswith(b'"t')
    assert runs["port"]["dump"] == runs["jax"]["dump"]


def test_generate_html_table():
    rows = [["0", "a <b>", "c"], ["1", "", "d"]]
    assert tr.generate_html_table(rows, ["Epoch", "Predicted", "GT"]) == \
        jr.generate_html_table(rows, ["Epoch", "Predicted", "GT"])


def test_precompute_embeddings_npz(tmp_path):
    jparams, _ = jb.blip2_init(jax.random.PRNGKey(9), JCFG, with_vision=False)
    tparams, _ = bridge.blip2(jax.tree_util.tree_map(np.asarray, jparams), {}, "cpu")
    rng = np.random.default_rng(3)
    chunks = [((f"d{i}", f"d{i + 1}"), rng.normal(size=(2, 5, 48)).astype(np.float32))
              for i in range(0, 6, 2)]
    n_j = jr.precompute_embeddings(jax.jit(lambda e: jb.blip2_forward_image(jparams, JCFG, e)),
                                   chunks, tmp_path / "j.npz")
    with torch.no_grad():
        n_t = tr.precompute_embeddings(
            lambda e: tb.blip2_forward_image(tparams, TCFG, torch.as_tensor(e)), chunks,
            tmp_path / "t.npz")
    assert n_t == n_j == 6
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(t.files) == sorted(j.files)
    for k in j.files:
        assert t[k].dtype == np.float32 and t[k].shape == (8, 32)
        np.testing.assert_allclose(t[k], j[k], **TOL)


# -------------------------------------------------------------------- logging
def test_smoothed_value_and_metric_logger():
    vals = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    a, b = tlog.SmoothedValue(window_size=4), jlog.SmoothedValue(window_size=4)
    for v in vals:
        a.update(v, n=2)
        b.update(v, n=2)
        assert (a.median, a.avg, a.global_avg, str(a)) == (b.median, b.avg, b.global_avg, str(b))
    printed = {"t": [], "j": []}
    for key, mod in (("t", tlog), ("j", jlog)):
        m = mod.MetricLogger(print_fn=printed[key].append)
        for i in m.log_every(range(5), 2, header="hdr"):
            m.update(loss=float(i), acc=np.float32(i / 10))
        assert m.global_avgs() == {"loss": 2.0, "acc": pytest.approx(0.2)}
    times = re.compile(r"\d+\.\d+s|\d+\.\d{4}")   # times differ; the rest does not
    assert [times.sub("T", x) for x in printed["t"]] == [times.sub("T", x) for x in printed["j"]]


def test_jsonl_logger_bytes(tmp_path):
    recs = [{"split": "train", "loss": 1.25, "n": 3}, {"x": np.float32(0.5), "best": True},
            {"t": torch.tensor(2.5)}]
    tl_, jl_ = tlog.JsonlLogger(tmp_path / "a" / "t.txt"), jlog.JsonlLogger(tmp_path / "j.txt")
    for r in recs[:2]:
        tl_.log(r)
        jl_.log(r)
    assert (tmp_path / "a" / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    tl_.log(recs[2])
    assert json.loads((tmp_path / "a" / "t.txt").read_text().splitlines()[-1]) == {"t": 2.5}


def test_wandb_profile_and_step_timer(tmp_path, monkeypatch):
    assert tlog.maybe_wandb(None) is None and jlog.maybe_wandb(None) is None
    monkeypatch.setitem(__import__("sys").modules, "wandb", None)   # not installed
    assert tlog.maybe_wandb("proj") is None and jlog.maybe_wandb("proj") is None
    with tlog.profile_trace(None) as prof:
        assert prof is None
    with tlog.profile_trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    timers = (tlog.StepTimer(), jlog.StepTimer())
    for timer in timers:
        assert timer.summary() == {}
        for _ in range(3):
            with timer.step(sync_on={"x": torch.ones(2)} if timer is timers[0] else None):
                pass
    assert sorted(timers[0].summary()) == sorted(timers[1].summary()) == \
        ["mean_s", "p50_s", "p90_s"]
