"""The port's evaluation harness (apps/evaluate.py ``run_eval`` with the
correction, binary-QA and all-QA passes) and its command line against the
JAX package's ``run_eval`` and the root test.py, on the mock pipelines with
bridged weights (JAX: quantize=True, int8 KV, flash-decode in Pallas
interpret mode), over the first 3 test studies of tests/fixtures with image
embeddings, 8 new tokens a report.

What is held, and how:
  * every generate_texts call of the port's run_eval has the arguments of
    JAX's call at the same place (prompts, image embeddings, new tokens);
  * the port's own greedy texts equal JAX's in the report pass (batch 3,
    8 tokens) and the QA passes (14 lanes x 10 tokens, 3 lanes x 30);
  * the batch-1 correction turns decode 256 tokens each. JAX's own jitted
    and eager W8A8 runs part at int8 rounding edges near greedy ties
    (ROADMAP.md section 3), and no weight seed of 0-23 keeps all three
    corrections equal (each diverges at a tie somewhere in 768 steps; seed
    0, used here, keeps two of three whole and the third to step ~200). So
    each correction is held through teacher forcing instead: JAX's 256
    greedy tokens are fed to the port's prefill and decode steps, and at
    every step JAX's token must be the port's argmax or within TIE of it
    (measured at seed 0: largest margin 0.0029, at the step where the texts
    part; logit std ~1). Control: a decode step whose mask leaves out the
    newest cache row (the token it was just fed) moves the largest margin
    to 0.11, 0.54 and 0.20 in the three turns. The logits themselves are
    held within test_torch_teacher_forced.py's bound at every seed of 0-23
    in test_torch_eval_corrections.py;
  * with JAX's correction texts passed downstream on the port's side, the
    metrics dicts are equal and the four written files equal byte for byte;
  * the port's command line (``main``, with ``--device cpu``) and the root
    test.py's ``main``, each given these pipelines, print the same lines and
    write the same files. JAX's generate_texts answers there from the calls recorded in
    the run above (the same arguments, asserted), so its decode runs once
    in this file.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from radialog_tpu.apps import evaluate as jev
from radialog_tpu.apps import pipeline as jpipe
from radialog_tpu.data.datasets import MimicPaths as JMimicPaths
from radialog_tpu.data.datasets import ReportGenData as JReportGenData
from radialog_tpu_torch import bridge
from radialog_tpu_torch.apps import evaluate as tev
from radialog_tpu_torch.apps.pipeline import PipelineConfig, RaDialogPipeline
from radialog_tpu_torch.apps.tokenization import pad_batch_right
from radialog_tpu_torch.data.datasets import MimicPaths, ReportGenData
from radialog_tpu_torch.decode import engine as te

import test_torch_llama as tll

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
SEED = 0                # see the module docstring
STUDIES, NEW = 3, 8
TIE = 0.05
OPTS = dict(use_embs=True, do_corr=True, do_cp_bin_qa=True, do_cp_all_qa=True,
            max_new_tokens=NEW, exp_name="mock_eval")
EXP = "img_matching_examples_ig2_noexamples_IMG_findings_embs"
FILES = ("predictions_{}.csv", "predictions_{}_after_corrections.csv", "labels_{}.csv",
         "results_{}.txt")
CLI = ["--mock", "--int8", "--use_embs", "--do_corr", "--do_cp_bin_qa", "--do_cp_all_qa",
       "--fixture-dir", str(FIXTURES), "--truncate", str(STUDIES),
       "--max_new_tokens", str(NEW)]


def _paths(mod):
    return mod(split_csv=str(FIXTURES / "split.csv"),
               sectioned_csv=str(FIXTURES / "sectioned.csv"),
               chexpert_csv=str(FIXTURES / "chexpert.csv"),
               predicted_findings_json=str(FIXTURES / "preds.json"))


@pytest.fixture(scope="module")
def pipelines():
    os.environ["RADIALOG_FLASH_DECODE_FORCE"] = "interpret"   # before the first trace
    jp = jpipe.RaDialogPipeline(jpipe.PipelineConfig(mock=True, quantize=True, seed=SEED))
    tp = RaDialogPipeline(PipelineConfig(mock=True, device="cpu", seed=SEED))
    tp.llama = bridge.llama_serving(tll.packed_tree(jp.llama), tp.llama_cfg, device="cpu")
    tp.lora = bridge.lora(jax.tree_util.tree_map(np.asarray, jp.lora), device="cpu")
    tp.chexbert = bridge.chexbert(jax.tree_util.tree_map(np.asarray, jp.chexbert), device="cpu")
    yield jp, tp
    os.environ.pop("RADIALOG_FLASH_DECODE_FORCE", None)


def _np(embs):
    return None if embs is None else np.asarray(embs.cpu() if torch.is_tensor(embs) else embs)


class _Recording:
    """JAX's generate_texts, recording each call, its output and the token
    ids it decoded; or, given ``calls``, answering from them (asserting the
    same arguments)."""

    def __init__(self, pipe, calls=None):
        self.pipe, self.real, self.replay = pipe, pipe.generate_texts, calls is not None
        self.calls, self.i = (calls if calls is not None else []), 0

    def __call__(self, prompts, img_embs=None, max_new_tokens=None, **kw):
        if self.replay:
            want = self.calls[self.i]
            self.i += 1
            assert (list(prompts), max_new_tokens, kw) == want[:1] + want[2:4]
            np.testing.assert_array_equal(_np(img_embs), want[1])
            return want[4]
        ids, decode = [], self.pipe.tokenizer.decode

        def recording(toks, **dkw):
            ids.append([int(t) for t in toks])
            return decode(toks, **dkw)
        self.pipe.tokenizer.decode = recording
        try:
            out = self.real(prompts, img_embs=img_embs, max_new_tokens=max_new_tokens, **kw)
        finally:
            del self.pipe.tokenizer.decode
        self.calls.append((list(prompts), _np(img_embs), max_new_tokens, kw, out, ids))
        return out


class _Port:
    """The port's generate_texts, held call by call against JAX's recorded
    ones: the same arguments; its own output kept; JAX's texts passed on
    downstream for the correction turns (held by teacher forcing)."""

    def __init__(self, pipe, calls):
        self.real, self.calls, self.i, self.own = pipe.generate_texts, calls, 0, []

    def __call__(self, prompts, img_embs=None, max_new_tokens=None, **kw):
        want = self.calls[self.i]
        self.i += 1
        assert (list(prompts), max_new_tokens, kw) == want[:1] + want[2:4]
        np.testing.assert_array_equal(_np(img_embs), want[1])
        out = self.real(prompts, img_embs=img_embs, max_new_tokens=max_new_tokens, **kw)
        self.own.append(out)
        return want[4] if max_new_tokens == tev.CORRECTION_NEW else out


@pytest.fixture(scope="module")
def runs(pipelines, tmp_path_factory):
    jp, tp = pipelines
    root = tmp_path_factory.mktemp("eval")
    provider = tev.mock_emb_provider(tp.llama_cfg.num_img_tokens, tp.llama_cfg.qformer_dim)
    jrec = JReportGenData(_paths(JMimicPaths), truncate=STUDIES).records()
    trec = ReportGenData(_paths(MimicPaths), truncate=STUDIES).records()
    jp.generate_texts = rec = _Recording(jp)
    try:
        ref = jev.run_eval(jp, jrec, jev.EvalOptions(output_dir=str(root / "jax"), **OPTS),
                           emb_provider=provider)
    finally:
        del jp.generate_texts
    tp.generate_texts = port = _Port(tp, rec.calls)
    try:
        got = tev.run_eval(tp, trec, tev.EvalOptions(output_dir=str(root / "port"), **OPTS),
                           emb_provider=provider)
    finally:
        del tp.generate_texts
    return {"ref": ref, "got": got, "root": root, "calls": rec.calls, "own": port.own,
            "provider": provider}


def test_run_eval_calls_the_pipeline_as_jax(runs):
    calls, own = runs["calls"], runs["own"]
    news = [c[2] for c in calls]
    assert news == [NEW] + [tev.CORRECTION_NEW] * STUDIES + [10] * STUDIES + [30]
    assert [len(c[0]) for c in calls] == [STUDIES] + [1] * STUDIES + [14] * STUDIES + [STUDIES]
    assert len(own) == len(calls)
    for c, o in zip(calls, own):
        if c[2] != tev.CORRECTION_NEW:
            assert o == c[4]                 # the port's own greedy texts


def test_correction_turns_differ_from_jax_only_at_near_ties(runs, pipelines):
    _, tp = pipelines
    cfg = tp.llama_cfg
    equal, worst = 0, 0.0
    for c, own in zip(runs["calls"], runs["own"]):
        if c[2] != tev.CORRECTION_NEW:
            continue
        (prompt,), embs, (forced,) = c[0], c[1], c[5]
        equal += own == c[4]
        assert len(forced) > 200
        ids = tp.tokenizer(prompt)["input_ids"]
        tok, lens = (torch.from_numpy(x) for x in pad_batch_right([ids], 0))
        dp = tp.decode_params(max_new_tokens=tev.CORRECTION_NEW)
        with torch.no_grad():
            cache, logits = te.prefill(tp.llama, cfg, tok, lens,
                                       te.default_cache_len(tok.shape[1], dp),
                                       img_embs=torch.from_numpy(embs), lora=tp.lora,
                                       policy=tp.policy)
            margins = []
            for step, t in enumerate(forced):
                margins.append(float(logits[0].max() - logits[0, t]))
                logits = te.decode_step(tp.llama, cfg, cache, torch.tensor([t]), lens,
                                        tok.shape[1], step, lora=tp.lora, policy=tp.policy)
        worst = max(worst, max(margins))
        assert max(margins) < TIE, (int(np.argmax(margins)), max(margins))
    assert equal >= 2, equal
    print(f"corrections equal to JAX: {equal} of {STUDIES}; largest margin {worst}")


def test_run_eval_metrics_match_jax(runs):
    assert runs["got"] == runs["ref"]
    assert len(runs["got"]) == 34 and all(np.isfinite(v) for v in runs["got"].values())


@pytest.mark.parametrize("name", FILES)
def test_run_eval_files_match_jax(runs, name):
    f = name.format(OPTS["exp_name"])
    assert (runs["root"] / "port" / f).read_bytes() == (runs["root"] / "jax" / f).read_bytes()


def _root_test_py():
    spec = importlib.util.spec_from_file_location("root_test_cli", REPO / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_matches_root_test_py(runs, pipelines, monkeypatch, capsys, tmp_path):
    jp, tp = pipelines
    jp.generate_texts = _Recording(jp, runs["calls"])
    tp.generate_texts = _Port(tp, runs["calls"])
    monkeypatch.setattr(jpipe, "RaDialogPipeline", lambda cfg: jp)
    monkeypatch.setattr(tev, "RaDialogPipeline", lambda cfg: tp)
    try:
        monkeypatch.setattr(sys, "argv", ["test.py", *CLI, "--output_dir", str(tmp_path / "jax")])
        _root_test_py().main()
        ref = capsys.readouterr().out
        tev.main([*CLI, "--device", "cpu", "--output_dir", str(tmp_path / "port")])
        got = capsys.readouterr().out
    finally:
        del jp.generate_texts, tp.generate_texts
    assert got == ref
    assert got.startswith(f"eval records: {STUDIES}\n")
    metrics = json.loads(got.split("\n", 1)[1])
    assert metrics == {k: round(float(v), 6) for k, v in runs["ref"].items()}
    for name in FILES:
        f = name.format(EXP)
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


# ------------------------------------------------------------- what raises
def test_run_eval_refuses_beams(pipelines, tmp_path, monkeypatch):
    """Beams were refused until decode/beam.py was ported: run_eval now
    hands num_beams to the report pass's generate_texts, and to no other
    pass, as the JAX run_eval does (beams against JAX:
    tests/test_torch_beam.py and test_torch_ckpt_pipeline.py)."""
    _, tp = pipelines
    seen = []
    real = tp.generate_texts
    monkeypatch.setattr(tp, "generate_texts", lambda prompts, **kw: seen.append(
        (kw.get("max_new_tokens"), kw.get("num_beams", 1))) or real(prompts, **kw))
    records = ReportGenData(_paths(MimicPaths), truncate=1).records()
    tev.run_eval(tp, records, tev.EvalOptions(num_beams=2, do_cp_all_qa=True,
                                              max_new_tokens=NEW, output_dir=str(tmp_path)))
    assert seen == [(NEW, 2), (30, 1)]


def test_run_eval_refuses_batched_speculative_corrections(pipelines, tmp_path):
    _, tp = pipelines
    opts = tev.EvalOptions(corr_spec=4, do_corr=True, output_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 5"):
        tev.run_eval(tp, [], opts)


class _Built(Exception):
    pass


@pytest.mark.parametrize("flag", ["vicuna_path", "lora_model", "blip2_checkpoint",
                                  "chexbert_checkpoint", "emb_cache"])
def test_cli_refuses_real_checkpoints(flag, tmp_path, monkeypatch):
    """The checkpoint flags were refused until the loaders were ported: each
    now reaches PipelineConfig as the root test.py passes it (the runs from
    files: tests/test_torch_ckpt_pipeline.py)."""
    field = {"lora_model": "lora_path"}.get(flag, flag)
    seen = []

    def capture(cfg):
        seen.append(cfg)
        raise _Built
    monkeypatch.setattr(tev, "RaDialogPipeline", capture)
    with pytest.raises(_Built):
        tev.main([*CLI, f"--{flag}", "x", "--device", "cpu", "--output_dir", str(tmp_path)])
    assert getattr(seen[0], field) == "x"


def test_cli_refuses_to_run_without_mock_or_synthetic(tmp_path):
    """Without --mock, --synthetic or --vicuna_path there are no weights."""
    with pytest.raises(ValueError, match="--vicuna_path"):
        tev.main(["--int8", "--device", "cpu", "--output_dir", str(tmp_path)])


def test_cli_refuses_the_float_pipeline(tmp_path, monkeypatch):
    """test.py runs float weights without --int8 or --w4, and so does the
    port now (it refused before the float pipeline existed): the stacked
    float tree over the bf16 cache, not W8A8 in its place. The run against
    the root test.py is tests/test_torch_float_pipeline.py's."""
    made = []
    real = tev.RaDialogPipeline
    monkeypatch.setattr(tev, "RaDialogPipeline", lambda cfg: made.append(real(cfg)) or made[-1])
    results = tev.main(["--mock", "--device", "cpu", "--fixture-dir", str(FIXTURES),
                        "--truncate", "1", "--max_new_tokens", "4",
                        "--output_dir", str(tmp_path)])
    (pipe,) = made
    assert not pipe.cfg.quantize and not pipe.cfg.use_kv_int8()
    assert isinstance(pipe.llama["layers"], dict)
    assert results and all(np.isfinite(v) for v in results.values())
    exp = "img_matching_examples_ig2_noexamples_IMG_findings_noembs"
    assert all((tmp_path / name.format(exp)).is_file() == ("after" not in name)
               for name in FILES)      # no correction pass asked for


@pytest.mark.parametrize("argv", [["--num_beams", "2"], ["--corr_spec", "3"]])
def test_cli_refuses_beams_and_batched_speculation(argv, tmp_path, monkeypatch):
    """--corr_spec still raises; --num_beams, refused until beams were
    ported, reaches EvalOptions (a beam run against the root test.py:
    tests/test_torch_ckpt_pipeline.py)."""
    if "--corr_spec" in argv:
        with pytest.raises(NotImplementedError):
            tev.main([*CLI, *argv, "--device", "cpu", "--output_dir", str(tmp_path)])
        return
    seen = []
    monkeypatch.setattr(tev, "run_eval", lambda pipe, records, opts, **kw: seen.append(opts) or {})
    tev.main([*CLI, *argv, "--device", "cpu", "--output_dir", str(tmp_path)])
    assert seen[0].num_beams == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the run without a card")
def test_cli_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.main([*CLI, "--output_dir", str(tmp_path)])


def test_cli_runs_as_a_module(tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "radialog_tpu_torch.apps.evaluate", "--mock", "--int8",
         "--device", "cpu", "--fixture-dir", "tests/fixtures", "--truncate", "2",
         "--max_new_tokens", "6", "--do_corr", "--output_dir", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    head, body = proc.stdout.split("\n", 1)
    assert head == "eval records: 2"
    metrics = json.loads(body)
    assert {"Bleu_1", "METEOR", "ROUGE_L", "chexbert_macro_f1", "corr_Bleu_4",
            "corr_chexbert_sample_f1"} <= set(metrics)
    exp = "img_matching_examples_ig2_noexamples_IMG_findings_noembs"
    for name in FILES:
        assert (out / name.format(exp)).is_file()
    assert len((out / f"predictions_{exp}_after_corrections.csv").read_text().splitlines()) == 2
