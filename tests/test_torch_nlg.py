"""The port's NLG scores against the JAX package's, and its copies of nltk
3.10.0's Treebank word tokenizer and Porter stemmer against nltk itself.

Compared token for token and stem for stem over every word of the test
fixtures, every word of METEOR_SYNONYM_GROUPS, the words of the doctest
files nltk ships (its Porter test vocabulary is a data download, not
shipped) and seeded generated strings with punctuation, quotes,
contractions and brackets. The scores are pure-Python float arithmetic in
the same order on both sides, so they are compared for equality."""
import importlib
import json
import re
from pathlib import Path

import nltk
import numpy as np
import pytest
from nltk.stem.porter import PorterStemmer as NltkPorter
from nltk.tokenize.treebank import TreebankWordTokenizer as NltkTreebank

from radialog_tpu_torch.eval import _porter, _treebank
from radialog_tpu_torch.eval import nlg as tnlg

jnlg = importlib.import_module("radialog_tpu.eval.nlg")

FIXTURES = Path(__file__).resolve().parent / "fixtures"
NLTK_TESTS = Path(nltk.__file__).parent / "test"


def _fixture_texts():
    texts = []
    for f in sorted(FIXTURES.glob("*.csv")):
        texts.append(f.read_text())
    for rec in json.loads((FIXTURES / "instruct.json").read_text()):
        texts.extend(str(v) for v in rec.values())
    return texts


def _nltk_doctest_texts():
    return [f.read_text(encoding="utf-8", errors="replace")
            for f in sorted(NLTK_TESTS.glob("*.doctest"))]


def _words(texts):
    return sorted({w for t in texts for w in re.split(r"[^A-Za-z'-]+", t) if w})


def _generated(n, seed):
    """Strings of words, numbers, punctuation, quotes, contractions and
    brackets in random order."""
    rng = np.random.default_rng(seed)
    parts = ["the", "heart", "is", "normal", "can't", "won't", "they'll", "I'm", "we'd",
             "cannot", "gonna", "wanna", "'tis", "'twas", "d'ye", "more'n", "lemme", "gotta",
             "3.88", "1,000", "3,36", "...", "--", "-", "(", ")", "[", "]", "{", "}", "<", ">",
             '"', "''", "``", "'", ",", ":", ";", "@", "#", "$", "%", "&", "?", "!", ".", "U.S.",
             "e.g.", "x-ray", "5-7", "effusion.", '"stable"', "'quoted'", "it's", "JOHN'S",
             "N'T", "O'Neil", "a:b", "c,d", "end.)", "end.\"", "\t", "\n", "  "]
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 25))
        seps = rng.choice(["", " ", " ", " "], size=k)
        out.append("".join(str(s) + str(p) for s, p in zip(seps, rng.choice(parts, size=k))))
    return out


VOCAB = {
    "fixtures": lambda: _words(_fixture_texts()),
    "synonyms": lambda: sorted({w for g in tnlg.METEOR_SYNONYM_GROUPS for w in g}),
    "nltk_doctests": lambda: _words(_nltk_doctest_texts()),
    "irregular": lambda: sorted(set(NltkPorter().pool) | set(NltkPorter().pool.values())
                                | {"dies", "died", "spied", "flies", "generically",
                                   "radically", "geology", "archaeology", "hopefulli"}),
    "generated": lambda: ["".join(np.random.default_rng(i).choice(list("aeiouybcdlmnrstyz"),
                                                                 size=1 + i % 14))
                          for i in range(3000)],
}


@pytest.mark.parametrize("vocab", sorted(VOCAB))
def test_porter_stems_equal_nltk(vocab):
    words = VOCAB[vocab]()
    assert len(words) > 20
    ours, theirs = _porter.PorterStemmer(), NltkPorter()
    got = [ours.stem(w) for w in words]
    assert got == [theirs.stem(w) for w in words]
    assert [ours.stem(w, to_lowercase=False) for w in words] == \
        [theirs.stem(w, to_lowercase=False) for w in words]


TEXTS = {
    "fixtures": lambda: [ln for t in _fixture_texts() for ln in t.splitlines()],
    "nltk_doctests": lambda: [ln for t in _nltk_doctest_texts() for ln in t.splitlines()],
    "generated": lambda: _generated(3000, 7),
}


@pytest.mark.parametrize("texts", sorted(TEXTS))
def test_treebank_tokens_equal_nltk(texts):
    lines = TEXTS[texts]()
    assert len(lines) > 30
    ours, theirs = _treebank.TreebankWordTokenizer(), NltkTreebank()
    for conv in (False, True):
        assert [ours.tokenize(x, convert_parentheses=conv) for x in lines] == \
            [theirs.tokenize(x, convert_parentheses=conv) for x in lines]


def test_tokenize_report_and_synonyms_equal_jax():
    for t in TEXTS["fixtures"]() + _generated(500, 8):
        assert tnlg.tokenize_report(t) == jnlg.tokenize_report(t)
        assert tnlg.preprocess_report(t + "<s></s>\n") == jnlg.preprocess_report(t + "<s></s>\n")
    assert tnlg.METEOR_SYNONYM_GROUPS == jnlg.METEOR_SYNONYM_GROUPS
    assert tnlg.METEOR_SYNONYMS == jnlg.METEOR_SYNONYMS


def _corpus(seed):
    """Reference findings of the fixtures and hypotheses made from them:
    words dropped, swapped, replaced by synonyms and stems, or unrelated."""
    import csv
    with open(FIXTURES / "sectioned.csv", newline="") as f:
        refs = [r["findings"] for r in csv.DictReader(f)]
    rng = np.random.default_rng(seed)
    swaps = {"edema": "oedema", "lungs": "lung", "heart": "cardiac", "small": "little",
             "stable": "unchanged", "opacity": "opacities", "effusion": "fluid"}
    preds = {}
    for i, ref in enumerate(refs):
        words = ref.split()
        mode = i % 4
        if mode == 0:
            words = [swaps.get(w.lower(), w) for w in words]
        elif mode == 1:
            words = [w for w in words if rng.random() > 0.3]
        elif mode == 2:
            rng.shuffle(words)
        else:
            words = [f"w{j}" for j in rng.integers(0, 50, size=rng.integers(0, 12))]
        preds[f"d{i}"] = " ".join(words)
    return preds, {f"d{i}": r for i, r in enumerate(refs)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scores_equal_jax(seed):
    preds, refs = _corpus(seed)
    got = tnlg.evaluate_reports(preds, refs)
    assert got == jnlg.evaluate_reports(preds, refs)
    assert got.as_dict() == jnlg.evaluate_reports(preds, refs).as_dict()
    res = {k: tnlg.tokenize_report(v) for k, v in preds.items()}
    gts = {k: [tnlg.tokenize_report(v), tnlg.tokenize_report(preds[k])] for k, v in refs.items()}
    assert tnlg.corpus_bleu(gts, res) == jnlg.corpus_bleu(gts, res)
    assert tnlg.corpus_bleu(gts, res, max_n=2) == jnlg.corpus_bleu(gts, res, max_n=2)
    assert tnlg.rouge_l_corpus(gts, res) == jnlg.rouge_l_corpus(gts, res)
    assert tnlg.meteor_corpus(gts, res) == jnlg.meteor_corpus(gts, res)
    syn = {"w1": frozenset({"w1", "lungs"})}
    assert tnlg.meteor_corpus(gts, res, synonyms=syn) == jnlg.meteor_corpus(gts, res, synonyms=syn)


def test_evaluate_reports_refuses_other_ids():
    with pytest.raises(ValueError):
        tnlg.evaluate_reports({"a": "x"}, {"b": "x"})
