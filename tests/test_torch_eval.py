"""The evaluation follow-up passes of the port against the JAX package: the
CheXbert labeler, the CE metrics, the QA prompts and parsers, and the
binary-QA and all-QA passes of the mock pipelines on bridged weights over
long conversation histories (the binary pass's shared prefix, image
included, is over 256 tokens, so the port's prefix prefill runs the plain
K3). The JAX decode takes its flash-decode kernel in Pallas interpret mode.

Tolerances: CheXbert logits atol=rtol=1e-5 (FP32, the same BERT math with
f32 sums in another order); labels, metrics, prompts, parses and the
generated texts are compared for equality. Equal greedy texts over 300-token
W8A8 histories hold only for weights with no activation on an int8 rounding
edge near a greedy tie: one element that rounds the other way moves a
row of the tiny model by ~1 %. With pipeline seeds 1 to 5 some lanes
diverged (JAX's own jitted and eager runs of one all-QA batch differ in 20
tokens of one lane at seed 1); seed 0 (below) agrees on every lane.
test_torch_teacher_forced.py holds the same decode paths to JAX at every
seed it tries, through teacher-forced logits within a stated bound."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.apps import evaluate as jev
from radialog_tpu.apps.pipeline import PipelineConfig as JPipelineConfig
from radialog_tpu.apps.pipeline import RaDialogPipeline as JPipeline
from radialog_tpu.data import downstream as jds
from radialog_tpu.data.datasets import CHEXPERT_COLS as J_DATASET_COLS
from radialog_tpu.models import bert as jbert
from radialog_tpu.models import chexbert as jcb
from radialog_tpu_torch import bridge
from radialog_tpu_torch.apps import evaluate as tev
from radialog_tpu_torch.apps.pipeline import MOCK_CHEXBERT, PipelineConfig, RaDialogPipeline
from radialog_tpu_torch.data import downstream as tds
from radialog_tpu_torch.eval import ce_metrics as tce
from radialog_tpu_torch.models import bert as tbert
from radialog_tpu_torch.models import chexbert as tcb

import test_torch_llama as tll

# the JAX package's eval/__init__ re-exports the function ce_metrics under
# the module's name
jce = importlib.import_module("radialog_tpu.eval.ce_metrics")

J_MOCK_BERT = jbert.BertConfig(**{f.name: getattr(MOCK_CHEXBERT, f.name)
                                 for f in dataclasses.fields(MOCK_CHEXBERT)})


def test_constants_are_the_jax_packages():
    assert tce.CHEXPERT_COLS == jce.CHEXPERT_COLS == J_DATASET_COLS
    assert tce.CHEXBERT_CONDITIONS == jce.CHEXBERT_CONDITIONS == list(jcb.CHEXBERT_CONDITIONS)


def test_ce_metrics_and_label_maps_match_jax():
    rng = np.random.default_rng(0)
    gt = rng.choice([np.nan, 1.0, 0.0, -1.0], size=(9, 14))
    pred = rng.choice([np.nan, 1.0, 0.0, -1.0], size=(9, 14))
    pred[0] = 0.0                                  # a row with nothing predicted
    assert tce.ce_metrics(gt, pred) == jce.ce_metrics(gt, pred)
    np.testing.assert_array_equal(tce.map_labels_for_scoring(gt), jce.map_labels_for_scoring(gt))
    np.testing.assert_array_equal(tcb.ce_label_cleanup(gt.copy()), jcb.ce_label_cleanup(gt.copy()))
    heads = [rng.normal(size=(9, 2 if i == 13 else 4)) for i in range(14)]
    np.testing.assert_array_equal(tcb.logits_to_labels(heads), jcb.logits_to_labels(heads))


@pytest.mark.parametrize("answer", ["ASSISTANT: Yes, there is.", "ASSISTANT: no. ASSISTANT: YES",
                                    "ASSISTANT: cardiomegaly and lung opacity; no edema",
                                    "nothing here"])
def test_qa_prompts_and_parsers_match_jax(answer):
    hist = "USER: <IMG> describe ASSISTANT: The heart is enlarged."
    assert tds.binary_qa_prompts(hist, tce.CHEXPERT_COLS) == \
        jds.binary_qa_prompts(hist, jce.CHEXPERT_COLS)
    assert tds.all_qa_prompt(hist) == jds.all_qa_prompt(hist)
    assert tds.binary_qa_parse(answer) == jds.binary_qa_parse(answer)
    assert tds.all_qa_parse(answer, tce.CHEXPERT_COLS) == jds.all_qa_parse(answer, jce.CHEXPERT_COLS)
    preds = np.random.default_rng(1).integers(0, 2, (4, 14))
    np.testing.assert_array_equal(tds.binary_qa_no_finding_fixup(preds, tce.CHEXPERT_COLS),
                                  jds.binary_qa_no_finding_fixup(preds, jce.CHEXPERT_COLS))


def test_chexbert_apply_matches_jax():
    params = jcb.chexbert_init(jax.random.PRNGKey(3), J_MOCK_BERT)
    tparams = bridge.chexbert(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 512, (3, 24)).astype(np.int32)
    mask = (np.arange(24)[None] < np.asarray([24, 11, 1])[:, None]).astype(np.int32)
    ref = jcb.chexbert_apply(params, J_MOCK_BERT, jnp.asarray(ids), jnp.asarray(mask))
    got = tcb.chexbert_apply(tparams, MOCK_CHEXBERT, torch.from_numpy(ids), torch.from_numpy(mask))
    assert [g.shape for g in got] == [(3, 4)] * 13 + [(3, 2)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tcb.logits_to_labels([g.numpy() for g in got]),
                                  jcb.logits_to_labels([np.asarray(r) for r in ref]))


@pytest.mark.parametrize("t", [24, 128, 201])
def test_bert_embeddings_past_max_position_match_jax(t):
    """More tokens than the mock's 128 positions: JAX's gather clamps every
    position past 127 to the last row, and so does the port."""
    params = jbert.bert_embeddings_init(jax.random.PRNGKey(5), J_MOCK_BERT)
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, params), "cpu")
    ids = np.random.default_rng(t).integers(3, 512, (2, t)).astype(np.int32)
    ref = jbert.bert_embeddings(params, J_MOCK_BERT, jnp.asarray(ids))
    got = tbert.bert_embeddings(tparams, MOCK_CHEXBERT, torch.from_numpy(ids))
    assert got.shape == (2, t, MOCK_CHEXBERT.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- the QA passes
N_STUDIES = 5


def _histories():
    """Decoded report-pass conversations: a shared system prompt, the <IMG>
    run, 230 words of study-specific text and a short answer: about 300
    tokens, so the binary pass's shared prefix (all but the last word) is
    past 256 tokens with the image in it."""
    sys_words = " ".join(f"sys{i}" for i in range(20))
    return [f"{sys_words} " + "<IMG> " * 32 + " ".join(f"s{j}w{i}" for i in range(230))
            + " ASSISTANT: " + " ".join(f"a{j}r{i}" for i in range(20))
            for j in range(N_STUDIES)]


@pytest.fixture(scope="module")
def pipelines():
    """The JAX mock pipeline (W8A8, int8 KV) and the port's mock with the
    JAX LLaMA and LoRA weights through the bridge, and one fixed set of
    image embeddings per study."""
    import os
    os.environ["RADIALOG_FLASH_DECODE_FORCE"] = "interpret"   # before the first trace
    jp = JPipeline(JPipelineConfig(mock=True, quantize=True, seed=0))
    tp = RaDialogPipeline(PipelineConfig(mock=True, device="cpu", seed=0))
    tp.llama = bridge.llama_serving(tll.packed_tree(jp.llama), tp.llama_cfg, device="cpu")
    tp.lora = bridge.lora(jax.tree_util.tree_map(np.asarray, jp.lora), device="cpu")
    embs = np.random.default_rng(3).normal(size=(N_STUDIES, 32, 32)).astype(np.float32)
    yield jp, tp, embs
    os.environ.pop("RADIALOG_FLASH_DECODE_FORCE", None)


def _recording(pipe):
    texts = []
    gen = pipe.generate_texts

    def rec(prompts, img_embs=None, max_new_tokens=None, **kw):
        out = gen(prompts, img_embs=img_embs, max_new_tokens=max_new_tokens, **kw)
        texts.append(out)
        return out
    pipe.generate_texts = rec
    return texts


@pytest.mark.parametrize("pass_name", ["run_binary_qa_pass", "run_all_qa_pass"])
def test_qa_pass_matches_jax(pipelines, pass_name):
    jp, tp, embs = pipelines
    hists = _histories()
    records = [{"dicom": f"d{j}"} for j in range(N_STUDIES)]
    gt = np.random.default_rng(4).choice([np.nan, 1.0, 0.0, -1.0], size=(N_STUDIES, 14))

    def provider(dicoms):
        return embs[[int(d[1:]) for d in dicoms]]

    if pass_name == "run_binary_qa_pass":    # one study: 14 lanes, the image in the prefix
        hists, records, gt = hists[:1], records[:1], gt[:1]
        ids = [tp.tokenizer(p)["input_ids"] for p in tds.binary_qa_prompts(hists[0],
                                                                           tce.CHEXPERT_COLS)]
        p0, img_in_prefix = tp._shared_prefix_len(ids, torch.from_numpy(embs[:1]).repeat(14, 1, 1))
        assert p0 >= 256 and img_in_prefix
    jtexts, ttexts = _recording(jp), _recording(tp)
    try:
        ref = getattr(jev, pass_name)(jp, records, hists, gt, jev.EvalOptions(use_embs=True),
                                      provider)
        got = getattr(tev, pass_name)(tp, records, hists, gt, tev.EvalOptions(use_embs=True),
                                      provider)
    finally:
        del jp.generate_texts, tp.generate_texts
    assert ttexts == jtexts
    assert got == ref


def test_batch_one_follow_up_matches_jax(pipelines):
    """One history alone, as the correction pass asks: no shared prefix,
    so the port prefills without a cache (plain K3 at 300+ tokens) and
    installs the K/V, as JAX's prefill does below batch 30."""
    jp, tp, embs = pipelines
    prompt = [tds.all_qa_prompt(_histories()[2])]
    ref = jp.generate_texts(prompt, img_embs=embs[2:3], max_new_tokens=12)
    got = tp.generate_texts(prompt, img_embs=torch.from_numpy(embs[2:3]), max_new_tokens=12)
    assert got == ref


def test_label_reports_matches_jax(pipelines):
    jp, tp, _ = pipelines
    tp.chexbert = bridge.chexbert(jax.tree_util.tree_map(np.asarray, jp.chexbert), device="cpu")
    texts = ["no acute cardiopulmonary process", "cardiomegaly with small effusions", "x"] * 7
    got = tp.label_reports(texts)
    assert got.shape == (21, 14)
    np.testing.assert_array_equal(got, jp.label_reports(texts))


@pytest.mark.parametrize("words", [160, 300])
def test_label_reports_of_long_texts_match_jax(pipelines, words, monkeypatch):
    """Texts of more tokens than the mock labeler's 128 positions: both cut
    at 512 tokens and read positions past 127 from the last row, so the
    token ids fed to CheXbert and the labels are JAX's."""
    from radialog_tpu.apps import pipeline as jpipe
    from radialog_tpu_torch.apps import pipeline as tpipe
    jp, tp, _ = pipelines
    tp.chexbert = bridge.chexbert(jax.tree_util.tree_map(np.asarray, jp.chexbert), device="cpu")
    seen = {"jax": [], "port": []}
    for mod, key in ((jpipe, "jax"), (tpipe, "port")):
        inner = mod.chexbert_apply

        def recording(p, cfg, toks, mask, _inner=inner, _key=key, **kw):
            seen[_key].append(np.asarray(toks))
            return _inner(p, cfg, toks, mask, **kw)
        monkeypatch.setattr(mod, "chexbert_apply", recording)
    vocab = ["heart", "size", "normal", "small", "left", "pleural", "effusion", "no",
             "pneumothorax", "mild", "edema", "cardiomegaly", "opacity", "stable"]
    rng = np.random.default_rng(words)
    texts = [" ".join(rng.choice(vocab, words)) for _ in range(8)]
    got = tp.label_reports(texts)
    ref = jp.label_reports(texts)
    assert seen["port"][0].shape[1] > MOCK_CHEXBERT.max_position
    assert len(seen["port"]) == len(seen["jax"])
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got, ref)
