"""The LoRA finetune loop of the PyTorch port
(radialog_tpu_torch/apps/finetune_lora.py, its tokenization and dataset
helpers and core/checkpoint.py) against the JAX package on
tests/fixtures/instruct.json.

The mock ``train`` of both packages starts from the same base and LoRA trees
(the JAX package's own, through the bridge) and sees the same batches (one
``np.random.Generator`` seed). The JAX run rounds its micro-batch up to its
8 virtual CPU devices, so both ask for 8 outright. Tolerances: every
micro-step's loss within 1e-4 (FP32, sums in another order, four AdamW
updates apart at most), the final LoRA tree within 1e-4."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from radialog_tpu.apps import finetune_lora as jft
from radialog_tpu.data import datasets as jdata
from radialog_tpu.data import tokenization as jtok
from radialog_tpu.models import llama as jl
from radialog_tpu.train import steps as jsteps
from radialog_tpu_torch import bridge
from radialog_tpu_torch.apps import finetune_lora as tft
from radialog_tpu_torch.apps import tokenization as ttok
from radialog_tpu_torch.core import checkpoint as tckpt
from radialog_tpu_torch.data import datasets as tdata
from radialog_tpu_torch.train import optim as toptim

REPO = Path(__file__).resolve().parents[1]
FIXTURE = str(REPO / "tests" / "fixtures" / "instruct.json")
RECORDS = json.loads(Path(FIXTURE).read_text())


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaves_np(tree):
    """Leaves as numpy, dicts in sorted key order (jax sorts keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_np(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves_np(v)]
    return [tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


# ------------------------------------------------------- tokenization, data
@pytest.mark.parametrize("cutoff,train_on_inputs,add_eos", [
    (64, False, False), (64, False, True), (64, True, True), (40, False, True),
    (48, False, False)])
def test_tokenize_with_masked_prompt_matches_jax(cutoff, train_on_inputs, add_eos):
    jt = jtok.WhitespaceTokenizer(vocab_size=256, num_img_tokens=32, img_token_id=250)
    tt = ttok.WhitespaceTokenizer(vocab_size=256, num_img_tokens=32, img_token_id=250)
    kw = dict(cutoff_len=cutoff, train_on_inputs=train_on_inputs, add_eos_token=add_eos)
    for r in RECORDS[:6] + [{"instruction": "Describe.", "output": "Clear lungs."}]:
        want = jtok.tokenize_with_masked_prompt(jt, jtok.Prompter(), r, **kw)
        got = ttok.tokenize_with_masked_prompt(tt, ttok.Prompter(), r, **kw)
        assert got == want
        assert (ttok.Prompter().generate_prompt(r["instruction"], r.get("input"), r["output"])
                == jtok.Prompter().generate_prompt(r["instruction"], r.get("input"), r["output"]))
    assert ttok.Prompter().get_response("USER: x ASSISTANT: fine ") == "fine"
    assert ttok.IGNORE_INDEX == jtok.IGNORE_INDEX


def test_pad_labels_right_matches_jax():
    labels = [[-100, -100, 5, 6], [7], list(range(12))]
    for t in (8, 16):
        np.testing.assert_array_equal(ttok.pad_labels_right(labels, t),
                                      jtok.pad_labels_right(labels, t))


def test_dataset_helpers_match_jax():
    assert tdata.load_instruct_dataset(FIXTURE) == jdata.load_instruct_dataset(FIXTURE)
    assert tdata.split_report_instruct(RECORDS) == jdata.split_report_instruct(RECORDS)
    assert tdata.split_report_instruct([{"task": "EL"}, {}]) == ([1], [0])
    rep, inst = tdata.split_report_instruct(RECORDS)
    for seed in (0, 7):
        assert (tdata.balanced_epoch_indices(rep, inst[:4], np.random.default_rng(seed))
                == jdata.balanced_epoch_indices(rep, inst[:4], np.random.default_rng(seed)))


def test_batcher_matches_jax():
    """Tokens, labels, lengths and the crc32 placeholder embeddings."""
    kw = dict(mock=True, cutoff_len=64, use_embs=True)
    jt = jtok.WhitespaceTokenizer(vocab_size=256, num_img_tokens=32, img_token_id=250)
    tt = ttok.WhitespaceTokenizer(vocab_size=256, num_img_tokens=32, img_token_id=250)
    cached = {"dcm003": np.ones((32, 32), np.float32)}
    want = jft._make_batcher(RECORDS, jt, jft.FinetuneConfig(**kw),
                             dataclasses.replace(jl.TINY_LLAMA, num_img_tokens=32), cached)
    got = tft._make_batcher(RECORDS, tt, tft.FinetuneConfig(**kw),
                            dataclasses.replace(tft.TINY_LLAMA, num_img_tokens=32), cached)
    a, b = got([3, 0, 17]), want([3, 0, 17])
    assert sorted(a) == sorted(b) == ["img_embs", "labels", "lengths", "tokens"]
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_config_keeps_the_jax_fields():
    jf = {f.name: f.default for f in dataclasses.fields(jft.FinetuneConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tft.FinetuneConfig)}
    del jf["mesh_model"]
    assert {k: tf[k] for k in jf} == jf
    assert set(tf) - set(jf) == {"synthetic", "device"} and tf["flash"] is False


# ------------------------------------------------------------------- train
CFG = dict(mock=True, data_path=FIXTURE, max_steps=4, num_epochs=4, cutoff_len=64,
           batch_size=16, micro_batch_size=8, use_embs=True)


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """The mock train of both packages from the same weights."""
    out = tmp_path_factory.mktemp("finetune")
    jlogs, tlogs, tsteps_seen = [], [], []
    jstate = jft.train(jft.FinetuneConfig(output_dir=str(out / "jax"), **CFG), log_fn=jlogs.append)
    cfg = jl.TINY_LLAMA
    base = as_np(jl.llama_init(jax.random.PRNGKey(0), dataclasses.replace(cfg, num_img_tokens=32)))
    lora = as_np(jl.lora_init(jax.random.PRNGKey(42), dataclasses.replace(cfg, num_img_tokens=32)))
    tcfg = tft.FinetuneConfig(output_dir=str(out / "torch"), device="cpu", **CFG)
    tstate = tft.train(tcfg, log_fn=tlogs.append,
                       on_step=lambda s, m: tsteps_seen.append((s, float(m["loss"]))),
                       base=bridge.llama_stacked(base, "cpu"), lora=bridge.lora(lora, "cpu"))
    return dict(out=out, jlogs=jlogs, tlogs=tlogs, steps=tsteps_seen, jstate=jstate,
                tstate=tstate, base=base, lora=lora, tcfg=tcfg)


def test_mock_train_matches_jax(both_runs):
    r = both_runs
    assert [s for s, _ in r["steps"]] == [1, 2, 3, 4]
    jl_ = [m for m in r["jlogs"] if "loss" in m or "val_loss" in m]
    tl_ = [m for m in r["tlogs"] if "loss" in m or "val_loss" in m]
    assert [sorted(m) for m in tl_] == [sorted(m) for m in jl_] and len(tl_) == 2
    assert abs(tl_[0]["loss"] - jl_[0]["loss"]) < 1e-4
    np.testing.assert_allclose(tl_[0]["grad_norm"], jl_[0]["grad_norm"], rtol=1e-3)
    assert tl_[1]["step"] == jl_[1]["step"] == 4 and tl_[1]["best"] is True
    assert abs(tl_[1]["val_loss"] - jl_[1]["val_loss"]) < 1e-4
    assert r["tstate"].step == int(r["jstate"].step) == 4
    moved = 0.0
    for got, want, start in zip(leaves_np(r["tstate"].params), leaves_np(as_np(r["jstate"].params)),
                                leaves_np(r["lora"])):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        moved = max(moved, float(np.abs(want - start).max()))
    assert moved > 1e-4        # two updates of about the learning rate each


def test_every_micro_step_loss_matches_jax(both_runs):
    """The JAX package's train logs step 1 only, so its step function is driven by
    hand over the same batches (the two packages' own batchers and order)."""
    r = both_runs
    cfg = jft.FinetuneConfig(**CFG)
    llama_cfg = dataclasses.replace(jl.TINY_LLAMA, num_img_tokens=32)
    tok = jtok.WhitespaceTokenizer(vocab_size=256, num_img_tokens=32, img_token_id=250)
    train_records = RECORDS[cfg.val_set_size:]
    batch_at = jft._make_batcher(train_records, tok, cfg, llama_cfg, {})
    tx = jft.make_adamw(jft.linear_warmup_cosine(cfg.learning_rate, cfg.learning_rate / 10,
                                                 warmup_steps=100, total_steps=4),
                        weight_decay=0.0, grad_clip=1.0, accum_steps=2)
    state = jsteps.TrainState.create(jax.tree_util.tree_map(jax.numpy.asarray, r["lora"]), tx)
    step_fn = jax.jit(jsteps.make_lora_train_step(tx, llama_cfg))
    base = jax.tree_util.tree_map(jax.numpy.asarray, r["base"])
    rng = np.random.default_rng(cfg.seed)
    losses = []
    for _ in range(4):         # one micro-batch of 8 per epoch out of 15 records
        order = rng.permutation(len(train_records)).tolist()
        batch = {k: jax.numpy.asarray(v) for k, v in batch_at(order[:8]).items()}
        state, m = step_fn(state, base, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose([x for _, x in r["steps"]], losses, rtol=0, atol=1e-4)
    logged = next(m for m in r["jlogs"] if "loss" in m)
    assert logged["step"] == 1 and abs(losses[0] - logged["loss"]) < 1e-5


def test_checkpoints_round_trip(both_runs, tmp_path):
    r = both_runs
    d = r["out"] / "torch"
    assert sorted(p.name for p in d.iterdir()) == sorted(
        p.name for p in (r["out"] / "jax").iterdir()) == ["best", "best.meta.json", "last",
                                                          "last.meta.json"]
    for name in ("best", "last"):
        tree, meta = tckpt.load_checkpoint(d, name, target=r["tstate"].params)
        jmeta = json.loads((r["out"] / "jax" / f"{name}.meta.json").read_text())
        assert meta["step"] == jmeta["step"] == 4 and abs(meta["metric"] - jmeta["metric"]) < 1e-4
        for got, want in zip(toptim.tree_leaves(tree), toptim.tree_leaves(r["tstate"].params)):
            assert got.dtype == want.dtype and torch.equal(got, want)
    # a whole TrainState, step_N names, latest_step and resuming from it
    tckpt.save_checkpoint(tmp_path, 3, r["tstate"])
    tckpt.save_checkpoint(tmp_path, 12, r["tstate"], {"note": "x"})
    assert tckpt.latest_step(tmp_path) == 12 and tckpt.latest_step(tmp_path / "none") is None
    state, meta = tckpt.load_checkpoint(tmp_path, "step_12", target=r["tstate"])
    assert meta == {"step": 12, "note": "x"} and type(state) is type(r["tstate"])
    assert state.step == 4 and state.opt_state["gradient_step"] == 2
    logs = []
    cfg = dataclasses.replace(r["tcfg"], resume_from_checkpoint=str(tmp_path / "step_12"),
                              max_steps=1, output_dir=str(tmp_path / "resumed"))
    resumed = tft.train(cfg, log_fn=logs.append, base=bridge.llama_stacked(r["base"], "cpu"))
    assert logs[0] == {"resumed_step": 12} and resumed.step == 5
    keeper = tckpt.BestKeeper(tmp_path / "k", mode="max")
    assert keeper.update(1, 0.5, {"w": torch.ones(2)})
    assert not keeper.update(2, 0.4, {"w": torch.zeros(2)})
    assert torch.equal(tckpt.load_checkpoint(tmp_path / "k", "best")[0]["w"], torch.ones(2))
    assert torch.equal(tckpt.load_checkpoint(tmp_path / "k", "last")[0]["w"], torch.zeros(2))


def test_export_adapter_matches_jax(both_runs, tmp_path):
    r = both_runs
    jft.export_adapter(as_np(r["jstate"].params), str(tmp_path / "jax.bin"))
    tft.export_adapter(r["tstate"].params, str(tmp_path / "torch.bin"))
    want, got = torch.load(tmp_path / "jax.bin"), torch.load(tmp_path / "torch.bin")
    assert list(got) == list(want) and len(got) == 2 * 2 * 2 + 2
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-4)


def test_train_refuses_what_is_not_ported():
    """Real checkpoints were refused until the loaders were ported (the runs
    from files: tests/test_torch_ckpt_pipeline.py). Now a run needs weights:
    base_model, mock or synthetic; and a lora_weights file is read."""
    with pytest.raises(ValueError, match="base_model required"):
        tft.train(tft.FinetuneConfig(data_path=FIXTURE, device="cpu"))
    with pytest.raises(ValueError, match="one of mock=True and synthetic=True"):
        tft.train(tft.FinetuneConfig(mock=True, synthetic=True, data_path=FIXTURE, device="cpu"))
    with pytest.raises(FileNotFoundError, match="x.bin"):
        tft.train(tft.FinetuneConfig(mock=True, lora_weights="x.bin", data_path=FIXTURE,
                                     device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tft.train(tft.FinetuneConfig(mock=True, data_path=FIXTURE))


@pytest.mark.parametrize("extra", [[], ["--quantize_base", "true", "--flash=true",
                                        "--cutoff_len", "256"]])
def test_cli_runs(tmp_path, extra):
    """python -m radialog_tpu_torch.apps.finetune_lora with the flags of the
    JAX package's root finetune.py."""
    cmd = [sys.executable, "-m", "radialog_tpu_torch.apps.finetune_lora", "--mock", "true",
           "--data_path", FIXTURE, "--batch_size", "4", "--micro_batch_size", "2",
           "--num_epochs", "1", "--max_steps=4", "--cutoff_len", "64", "--eval_steps", "2",
           "--use_embs", "true", "--use_instruct_data", "true", "--val_set_size", "2",
           "--output_dir", str(tmp_path / "out"), "--device", "cpu", *extra]
    done = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    lines = [json.loads(x) for x in done.stdout.splitlines() if x.startswith("{")]
    assert done.stdout.startswith("finetune config: FinetuneConfig(")
    assert [m["step"] for m in lines if "val_loss" in m] == [2, 4]
    assert all(np.isfinite(m.get("loss", m.get("val_loss"))) for m in lines)
    assert (tmp_path / "out" / "last" / tckpt.TREE_FILE).exists()
    bad = subprocess.run(cmd[:3] + ["--mesh_model", "2"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert bad.returncode != 0 and "unknown option --mesh_model" in bad.stderr
