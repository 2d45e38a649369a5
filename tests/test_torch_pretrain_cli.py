"""The port's stage-1 command line (python -m radialog_tpu_torch.apps.pretrain)
against the root pretrain.py.

``--mock`` and ``--mock --evaluate`` run in this process on both sides from
the same weights (the port's ``blip2_init`` replaced by the JAX init of the
root script's key, through bridge.blip2) and the same random batches (both
draw them from numpy's default_rng(0)), with both negative samplers
replaced by one fixed choice (each row's negative is the next row): the
log's numbers and the embeddings rtol = atol = 1e-5, the prediction and
ground-truth files byte-equal, the printed lines equal but for their
times. ``--mock --raw`` runs the port in a subprocess (``python -m``) and
holds its lines to the root script's format and count: the native loader
with two threads emits in the order its workers finish, so the two runs'
batches, and their losses, differ by design. A run that is not a mock
stops with the root script's message.
"""
import contextlib
import io
import json
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.models import blip2 as jb
from radialog_tpu.models import qformer as jq
from radialog_tpu_torch import bridge
from radialog_tpu_torch.apps import pretrain as tp
from radialog_tpu_torch.models import blip2 as tb

REPO = Path(__file__).resolve().parent.parent
ARGS = ["--mock", "--max-epoch", "1", "--steps-per-epoch", "2"]
TOL = dict(rtol=1e-5, atol=1e-5)
TIMES = re.compile(r"\d+\.\d+s|time: \d+\.\d{4}|data: \d+\.\d{4}|\(\d+\.\d{4} s/it\)")


def _patch(mp):
    mp.setattr(jax.random, "categorical",
               lambda key, logits: (jnp.arange(logits.shape[0]) + 1) % logits.shape[0])
    mp.setattr(tb, "sample_negatives",
               lambda w1, w2, gen: ((torch.arange(w1.shape[0]) + 1) % w1.shape[0],) * 2)
    jparams, _ = jb.blip2_init(jax.random.PRNGKey(0),
                               jb.Blip2Config(qformer=jq.TINY_QFORMER, max_txt_len=16),
                               with_vision=False)
    weights = jax.tree_util.tree_map(np.asarray, jparams)
    mp.setattr(tp, "blip2_init",
               lambda gen, cfg, device, with_vision=False: bridge.blip2(weights, {}, "cpu"))


def _root(mp, argv):
    mp.setattr(sys, "argv", ["pretrain.py", *argv])
    runpy.run_path(str(REPO / "pretrain.py"), run_name="__main__")


@pytest.fixture(scope="module")
def mock_runs(tmp_path_factory):
    """Both command lines' --mock and --mock --evaluate runs, and what each printed."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        _patch(mp)
        for name in ("root", "port"):
            d = tmp_path_factory.mktemp(name)
            argv = ARGS + ["--output-dir", str(d / "out")]
            eval_argv = ARGS + ["--evaluate", "--emb-out", str(d / "embs.npz")]
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                if name == "root":
                    _root(mp, argv)
                    _root(mp, eval_argv)
                else:
                    tp.main(argv + ["--device", "cpu"])
                    tp.main(eval_argv + ["--device", "cpu"])
            out[name] = {"dir": d, "printed": printed.getvalue()}
    finally:
        mp.undo()
    return out


def test_mock_training_against_root(mock_runs):
    root, port = mock_runs["root"], mock_runs["port"]
    norm = [TIMES.sub("T", d["printed"]).replace(str(d["dir"]), "DIR") for d in (port, root)]
    assert norm[0] == norm[1]
    logs = [[json.loads(x) for x in (d["dir"] / "out" / "log.txt").read_text().splitlines()]
            for d in (port, root)]
    assert [sorted(x) for x in logs[0]] == [sorted(x) for x in logs[1]] and len(logs[0]) == 3
    for a, b in zip(*logs):
        for k in a:
            if isinstance(a[k], float):
                np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=k)
            else:
                assert a[k] == b[k]
    for path in ("predictions/predictions_val.txt", "ground_truths/ground_truths_val.txt"):
        assert (port["dir"] / "out" / path).read_bytes() == \
            (root["dir"] / "out" / path).read_bytes(), path
    assert (port["dir"] / "out" / "best" / "tree.pt").exists()


def test_mock_evaluate_against_root(mock_runs):
    got = np.load(mock_runs["port"]["dir"] / "embs.npz")
    want = np.load(mock_runs["root"]["dir"] / "embs.npz")
    assert sorted(got.files) == sorted(want.files) == [f"d{i}" for i in range(6)]
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], **TOL)
    assert "precomputed 6 embeddings -> " in mock_runs["port"]["printed"]


def test_mock_raw_as_a_module():
    proc = subprocess.run([sys.executable, "-m", "radialog_tpu_torch.apps.pretrain", *ARGS,
                           "--raw", "--device", "cpu"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    # the root script's line: f"epoch {epoch}.{sub} it {it}: loss={..:.4f} itc=.. itm=.. lm=.."
    fmt = re.compile(r"epoch 0\.[01] it [01]: loss=(\S+) itc=(\S+) itm=(\S+) lm=(\S+)$")
    steps = [fmt.match(x) for x in lines[:-1]]
    assert len(steps) == 4 and all(steps)
    for m in steps:
        vals = [float(v) for v in m.groups()]
        assert all(np.isfinite(vals)) and vals[0] == pytest.approx(sum(vals[1:]), abs=2e-4)
    assert re.match(r"raw-image stage-1 mock done \(JPEG -> (native|pil) loader -> loss",
                    lines[-1])


def test_non_mock_run_stops_as_the_root_script(monkeypatch):
    with pytest.raises(SystemExit) as got:
        tp.main(["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        _root(monkeypatch, [])
    assert str(got.value) == str(want.value) and "MIMIC-CXR" in str(got.value)
