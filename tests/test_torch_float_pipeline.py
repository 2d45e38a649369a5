"""The float pipeline of the PyTorch port (``PipelineConfig(quantize=False)``:
``llama_init``'s stacked tree over the bf16 cache, the JAX package's default)
against the JAX mock pipeline on the same weights through the bridge, at the
mock's size (FP32 policy) on the CPU:

  * ``generate_texts`` (batch engine) and ``generate_texts_ring`` (the bf16
    ring on the stacked params) give JAX's texts; prefix sharing is off on
    both sides, whatever ``shared_prefix`` says;
  * the configuration's refusals are JAX's (an int8 cache or W4A8 layers
    without ``quantize``);
  * the command line without ``--int8`` (``main`` of apps/evaluate.py, as
    ``python -m radialog_tpu_torch.apps.evaluate --mock --device cpu``)
    against the root test.py's float mock run, both given these pipelines,
    over 2 fixture studies with every pass: the same printed lines and
    byte-equal files. The report and QA texts are the port's own and equal
    JAX's; each 256-token correction turn decodes on both sides, JAX's text
    goes downstream (as in tests/test_torch_eval_harness.py) and the first
    is held by teacher forcing: every JAX token within TIE of the port's
    argmax (measured: both corrections token-equal, largest margin 0; the
    float mock has no int8 rounding edge to cross).
"""
import contextlib
import io
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from radialog_tpu.apps import pipeline as jpipe
from radialog_tpu_torch import bridge
from radialog_tpu_torch.apps import evaluate as tev
from radialog_tpu_torch.apps.pipeline import PipelineConfig, RaDialogPipeline
from radialog_tpu_torch.apps.tokenization import pad_batch_right
from radialog_tpu_torch.decode import engine as te

from test_torch_eval_harness import FILES, FIXTURES, REPO, TIE, _Port, _Recording, _root_test_py

STUDIES, NEW = 2, 6
CLI = ["--mock", "--use_embs", "--do_corr", "--do_cp_bin_qa", "--do_cp_all_qa",
       "--fixture-dir", str(FIXTURES), "--truncate", str(STUDIES), "--max_new_tokens", str(NEW)]
EXP = "img_matching_examples_ig2_noexamples_IMG_findings_embs"


@pytest.fixture(scope="module")
def pipelines():
    jp = jpipe.RaDialogPipeline(jpipe.PipelineConfig(mock=True, seed=0))
    tp = RaDialogPipeline(PipelineConfig(mock=True, quantize=False, device="cpu", seed=0))
    trees = {name: jax.tree_util.tree_map(np.array, getattr(jp, name))
             for name in ("llama", "lora", "chexbert")}
    return jp, bridge.pipeline_weights(tp, trees)


def _prompts():
    return [f"w{j} r{j} " + "<IMG> " * 32 + " ".join(f"t{j}x{i}" for i in range(2 + 9 * j))
            for j in range(4)]


def test_the_float_pipeline_is_the_stacked_tree_over_the_bf16_cache(pipelines):
    _, tp = pipelines
    own = RaDialogPipeline(PipelineConfig(mock=True, quantize=False, device="cpu"))
    assert isinstance(own.llama["layers"], dict) and own.llama["embed"].dtype == torch.float32
    assert own.lora["layers"]["wq"]["a"].dtype == torch.float32
    assert not own.cfg.use_kv_int8() and own.decode_params().unroll == 1
    # the mock's float weights are those its quantized pipeline packs (the
    # serving embedding table in bf16)
    q = RaDialogPipeline(PipelineConfig(mock=True, device="cpu"))
    assert isinstance(q.llama["layers"], list) and q.cfg.use_kv_int8()
    assert torch.equal(q.llama["embed"], own.llama["embed"].to(q.llama["embed"].dtype))
    assert isinstance(tp.llama["layers"], dict)


def test_config_refusals_match_jax():
    for mod in (jpipe, sys.modules[PipelineConfig.__module__]):
        with pytest.raises(ValueError, match="weight_bits=4 requires quantize"):
            mod.PipelineConfig(mock=True, quantize=False, weight_bits=4)
        with pytest.raises(ValueError, match="kv_int8=True requires quantize"):
            mod.PipelineConfig(mock=True, quantize=False, kv_int8=True).use_kv_int8()
        assert not mod.PipelineConfig(quantize=False).use_kv_int8()
        assert not mod.PipelineConfig(quantize=False, kv_int8=False).use_kv_int8()
        assert mod.PipelineConfig(quantize=True).use_kv_int8()
    assert PipelineConfig().quantize and not jpipe.PipelineConfig().quantize


def test_generate_texts_and_the_ring_match_jax(pipelines):
    jp, tp = pipelines
    rng = np.random.default_rng(1)
    embs = rng.normal(size=(4, 32, tp.llama_cfg.qformer_dim)).astype(np.float32)
    prompts = _prompts()
    want = jp.generate_texts(prompts, img_embs=jax.numpy.asarray(embs), max_new_tokens=7)
    got = tp.generate_texts(prompts, img_embs=torch.from_numpy(embs), max_new_tokens=7)
    assert got == want
    ring = tp.generate_texts_ring(prompts, max_new_tokens=7, lanes=3, steps_per_call=4,
                                  img_embs=torch.from_numpy(embs))
    assert ring == got == jp.generate_texts_ring(prompts, max_new_tokens=7, lanes=3,
                                                 steps_per_call=4,
                                                 img_embs=jax.numpy.asarray(embs))


def test_prefix_sharing_is_off(pipelines, monkeypatch):
    """A batch of 14 questions about one study shares ~50 tokens and the
    image: the quantized path shares them, the float path (like JAX's)
    does not."""
    jp, tp = pipelines
    prompts = ["a b c d e f g h i j k l m n o p q r s t " + "<IMG> " * 32 + f"q{i} z"
               for i in range(14)]
    ids = [tp.tokenizer(p)["input_ids"] for p in prompts]
    embs = torch.zeros(14, 32, tp.llama_cfg.qformer_dim)
    assert tp.cfg.shared_prefix and tp._shared_prefix_len(ids, embs) == (0, False)
    assert jp._shared_prefix_len(ids, jax.numpy.zeros(embs.shape)) == (0, False)
    q = RaDialogPipeline(PipelineConfig(mock=True, device="cpu"))
    assert q._shared_prefix_len(ids, embs)[0] >= 16
    monkeypatch.setattr(sys.modules[RaDialogPipeline.__module__], "generate_shared_prefix",
                        None)                                  # never reached
    assert len(tp.generate_texts(prompts[:3], img_embs=embs[:3], max_new_tokens=2)) == 3


@pytest.fixture(scope="module")
def cli_runs(pipelines, tmp_path_factory):
    """The root test.py's float mock run and the port's command line, each
    given these pipelines (the JAX one recording its generate_texts calls,
    the port's held against them call by call)."""
    jp, tp = pipelines
    root = tmp_path_factory.mktemp("float_cli")
    rec = _Recording(jp)
    port = _Port(tp, rec.calls)
    made = []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jpipe, "RaDialogPipeline", lambda cfg: (made.append(cfg), jp)[1])
        mp.setattr(tev, "RaDialogPipeline", lambda cfg: (made.append(cfg), tp)[1])
        mp.setattr(jp, "generate_texts", rec, raising=False)
        mp.setattr(tp, "generate_texts", port, raising=False)
        mp.setattr(sys, "argv", ["test.py", *CLI, "--output_dir", str(root / "jax")])
        out = []
        for run in (lambda: _root_test_py().main(),
                    lambda: tev.main([*CLI, "--device", "cpu", "--output_dir",
                                      str(root / "port")])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                run()
            out.append(buf.getvalue())
    finally:
        mp.undo()
    return {"root": root, "out": out, "calls": rec.calls, "own": port.own, "cfgs": made}


def test_cli_without_int8_matches_root_test_py(cli_runs):
    jcfg, tcfg = cli_runs["cfgs"]
    assert not jcfg.quantize and not tcfg.quantize and tcfg.weight_bits == 8
    ref, got = cli_runs["out"]
    assert got == ref and got.startswith(f"eval records: {STUDIES}\n")
    metrics = json.loads(got.split("\n", 1)[1])
    assert len(metrics) == 34 and all(np.isfinite(v) for v in metrics.values())
    for name in FILES:
        f = name.format(EXP)
        assert (cli_runs["root"] / "port" / f).read_bytes() == \
            (cli_runs["root"] / "jax" / f).read_bytes()
    news = [c[2] for c in cli_runs["calls"]]
    assert news == [NEW] + [tev.CORRECTION_NEW] * STUDIES + [10] * STUDIES + [30]
    for c, own in zip(cli_runs["calls"], cli_runs["own"]):
        if c[2] != tev.CORRECTION_NEW:
            assert own == c[4]                  # the port's own greedy texts


def test_a_correction_turn_held_by_teacher_forcing(cli_runs, pipelines):
    _, tp = pipelines
    c = next(c for c in cli_runs["calls"] if c[2] == tev.CORRECTION_NEW)
    (prompt,), embs, (forced,) = c[0], c[1], c[5]
    assert len(forced) > 200
    ids = tp.tokenizer(prompt)["input_ids"]
    tok, lens = (torch.from_numpy(x) for x in pad_batch_right([ids], 0))
    dp = tp.decode_params(max_new_tokens=tev.CORRECTION_NEW)
    margins = []
    with torch.no_grad():
        cache, logits = te.prefill(tp.llama, tp.llama_cfg, tok, lens,
                                   te.default_cache_len(tok.shape[1], dp),
                                   img_embs=torch.from_numpy(embs), lora=tp.lora,
                                   policy=tp.policy, kv_int8=False)
        for step, t in enumerate(forced):
            margins.append(float(logits[0].max() - logits[0, t]))
            logits = te.decode_step(tp.llama, tp.llama_cfg, cache, torch.tensor([t]), lens,
                                    tok.shape[1], step, lora=tp.lora, policy=tp.policy)
    equal = sum(o == c_[4] for c_, o in zip(cli_runs["calls"], cli_runs["own"])
                if c_[2] == tev.CORRECTION_NEW)
    print(f"corrections equal to JAX: {equal} of {STUDIES}; largest margin {max(margins)}")
    assert max(margins) < TIE, (int(np.argmax(margins)), max(margins))


def test_cli_without_int8_runs_as_a_module(tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "radialog_tpu_torch.apps.evaluate", "--mock", "--device", "cpu",
         "--fixture-dir", "tests/fixtures", "--truncate", "2", "--max_new_tokens", "6",
         "--do_corr", "--use_embs", "--do_cp_bin_qa", "--do_cp_all_qa",
         "--output_dir", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    head, body = proc.stdout.split("\n", 1)
    assert head == "eval records: 2"
    metrics = json.loads(body)
    assert {"Bleu_1", "ROUGE_L", "chexbert_macro_f1", "corr_Bleu_4"} <= set(metrics)
    for name in FILES:
        assert (out / name.format(EXP)).is_file()
