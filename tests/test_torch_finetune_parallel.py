"""The port's LoRA finetune loop across ranks (radialog_tpu_torch/apps/
finetune_lora.py ``train`` inside a process group, ``export_adapter(mesh=)``,
``resume_from_checkpoint`` re-sharded) against its own one-process run on
the same mock weights and batches.

Two gloo rank processes (tests/torch_tp_ranks.py) train at mesh_model 2
(TP = 2) and 1 (DP = 2), then resume at TP = 2 from a one-process
TrainState, then refuse mesh_model 3. The one-process runs are made here.

Bounds: the logged loss, grad_norm and validation losses within 1e-5
(FP32, the same operations with f32 sums in another order; one micro-step
measured ~1e-7 relative); the LoRA tree after two AdamW updates within 1e-4
(AdamW divides by sqrt(v), so a leaf whose gradient is near 0 moves by a
fraction of the 3e-4 learning rate on rounding noise; the one-process
test_torch_finetune.py holds the same tree to JAX's at 1e-4).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from radialog_tpu_torch.apps import finetune_lora as tft
from radialog_tpu_torch.core import checkpoint as tckpt
from radialog_tpu_torch.train import steps as tsteps

import torch_tp_ranks

REPO = Path(__file__).resolve().parents[1]
FIXTURE = str(REPO / "tests" / "fixtures" / "instruct.json")
CFG = dict(mock=True, data_path=FIXTURE, max_steps=4, num_epochs=4, cutoff_len=64,
           batch_size=16, micro_batch_size=8, use_embs=True, eval_steps=2, device="cpu")
LOG_TOL = dict(rtol=1e-5, atol=1e-6)
TREE_TOL = dict(rtol=0, atol=1e-4)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _flat(sub, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree.detach().cpu().numpy()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ft")
    logs, steps = [], []
    one = tft.train(tft.FinetuneConfig(**CFG, output_dir=str(out / "one")), log_fn=logs.append,
                    on_step=lambda s, m: steps.append(float(m["loss"])))
    tckpt.save_checkpoint(out / "state", 4, one)
    rlogs = []
    resumed = tft.train(tft.FinetuneConfig(**dict(CFG, max_steps=2), output_dir=str(out / "r1"),
                                           resume_from_checkpoint=str(out / "state" / "step_4")),
                        log_fn=rlogs.append)
    tft.export_adapter(one.params, str(out / "one.bin"))
    ranks = torch_tp_ranks.run_ranks(
        {"kind": "finetune", "cfg": CFG, "base": None, "lora": None, "out": str(out),
         "resume": str(out / "state" / "step_4")}, 2, out, timeout=240)
    return dict(out=out, logs=logs, steps=steps, one=one, resumed=resumed, rlogs=rlogs,
                ranks=ranks)


def _numbers(logs):
    return [(k, m[k]) for m in logs for k in ("loss", "grad_norm", "val_loss") if k in m]


@pytest.mark.parametrize("m", [2, 1])
def test_logged_losses_match_one_process(runs, m):
    r0, r1 = runs["ranks"]
    assert r1[m]["logs"] == []                      # rank 0 alone logs
    got, want = _numbers(r0[m]["logs"]), _numbers(runs["logs"])
    assert [k for k, _ in got] == [k for k, _ in want] == ["loss", "grad_norm", "val_loss",
                                                           "val_loss"]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], **LOG_TOL)
    assert r0[m]["step"] == r1[m]["step"] == runs["one"].step == 4
    for key, val in _flat(runs["one"].params).items():
        for r in (r0, r1):
            np.testing.assert_allclose(r[m]["params"][key], val, **TREE_TOL, err_msg=key)


@pytest.mark.parametrize("m", [2, 1])
def test_rank0_checkpoint_is_the_one_device_layout(runs, m):
    """best/ and last/ written once, by rank 0, gathered: the one-process
    tree's structure, shapes and dtypes, its values within the tree bound,
    and it drives the one-process loss as the one-process checkpoint does."""
    d, one = runs["out"] / f"m{m}", runs["out"] / "one"
    assert sorted(p.name for p in d.iterdir()) == sorted(p.name for p in one.iterdir())
    for name in ("best", "last"):
        got, meta = tckpt.load_checkpoint(d, name)
        want, wmeta = tckpt.load_checkpoint(one, name)
        assert meta["step"] == wmeta["step"]
        np.testing.assert_allclose(meta["metric"], wmeta["metric"], **LOG_TOL)
        gf, wf = _flat(got), _flat(want)
        assert {k: (v.shape, v.dtype) for k, v in gf.items()} == \
            {k: (v.shape, v.dtype) for k, v in wf.items()}
        for k in wf:
            np.testing.assert_allclose(gf[k], wf[k], **TREE_TOL, err_msg=k)
    loaded, _ = tckpt.load_checkpoint(d, "last", target=runs["one"].params)
    base = tft._build_model(tft.FinetuneConfig(**CFG), torch.device("cpu"))
    batch = {k: torch.from_numpy(v) for k, v in tft._make_batcher(
        json.loads(Path(FIXTURE).read_text())[:8], base[1], tft.FinetuneConfig(**CFG), base[0],
        {})(list(range(8))).items()}
    with torch.no_grad():
        got = tsteps.lora_loss_fn(loaded, base[2], base[0], batch)
        want = tsteps.lora_loss_fn(runs["one"].params, base[2], base[0], batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


@pytest.mark.parametrize("m", [2, 1])
def test_gathered_adapter_export(runs, m):
    got = torch.load(runs["out"] / f"m{m}.bin")
    want = torch.load(runs["out"] / "one.bin")
    assert list(got) == list(want) and len(got) == 2 * 2 * 2 + 2
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TREE_TOL, err_msg=k)


def test_resume_reshards_params_and_moments(runs):
    """A one-process TrainState resumed at TP = 2: two more micro-steps (one
    AdamW update, from the saved moments) give the one-process resumed tree."""
    r0 = runs["ranks"][0]["resumed"]
    assert r0["logs"][0] == runs["rlogs"][0] == {"resumed_step": 4}
    assert r0["step"] == runs["resumed"].step == 6
    for key, val in _flat(runs["resumed"].params).items():
        np.testing.assert_allclose(r0["params"][key], val, **TREE_TOL, err_msg=key)
    moved = max(float(np.abs(r0["params"][k] - v).max())
                for k, v in _flat(runs["one"].params).items())
    assert moved > 0                               # the resumed step did update


def test_mesh_model_must_divide_the_ranks(runs):
    for r in runs["ranks"]:
        assert r["refused"] == "model axis 3 does not divide device count 2"
    with pytest.raises(ValueError, match="model axis 2 does not divide device count 1"):
        tft.train(tft.FinetuneConfig(**CFG, mesh_model=2, output_dir=str(runs["out"] / "x")))

