"""NLG metrics: BLEU-1..4, ROUGE-L and METEOR, pure Python (port of
radialog_tpu/eval/nlg.py; the arithmetic is that module's, so the scores
are equal, not close).

  * BLEU: corpus-level with clipped modified n-gram precision, the
    tiny/small smoothing and the closest-reference brevity penalty of the
    MS-COCO BleuScorer.
  * ROUGE-L: mean per-segment LCS F-measure with beta=1.2 (MS-COCO Rouge).
  * METEOR: exact, Porter-stem and synonym alignment stages with alpha=.9,
    beta=3, gamma=.5 (the Lavie-Agarwal 2007 defaults nltk also uses), with
    nltk meteor_score's alignment order and a vendored radiology synonym
    table (METEOR_SYNONYM_GROUPS) in place of WordNet.
  * Tokenization: sentences split on [.!?] before whitespace, then the Penn
    Treebank word tokenizer per sentence, lowercased.

The Treebank tokenizer and the Porter stemmer are copies of nltk 3.10.0's
(``_treebank.py``, ``_porter.py``), so the scores need no nltk.
"""
from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

from ._porter import PorterStemmer
from ._treebank import TreebankWordTokenizer

_TREEBANK = TreebankWordTokenizer()
_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


def preprocess_report(s: str) -> str:
    """ReportDataset.py:401-405: drop newlines and <s>/</s> markers."""
    return s.replace("\n", "").replace("<s>", "").replace("</s>", "")


def tokenize_report(s: str) -> List[str]:
    """word_tokenize's tokens (see the module docstring), lowercased."""
    toks: List[str] = []
    for sent in _SENT_SPLIT.split(preprocess_report(s).strip()):
        if sent:
            toks.extend(_TREEBANK.tokenize(sent))
    return [t.lower() for t in toks]


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(gts: Dict[str, List[List[str]]], res: Dict[str, List[str]],
                max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n, MS-COCO BleuScorer semantics.

    gts: id -> list of reference token lists; res: id -> hypothesis tokens.
    Clipped counts summed over the corpus; brevity penalty from the
    closest-length reference; smoothing: (correct+tiny)/(guess+small).
    """
    small, tiny = 1e-9, 1e-15
    correct = [0.0] * max_n
    guess = [0.0] * max_n
    testlen = 0
    reflen = 0
    for key, hyp in res.items():
        refs = gts[key]
        testlen += len(hyp)
        # closest reference length (ties -> shorter, as in BleuScorer)
        reflen += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hyp_ng = _ngrams(hyp, n)
            max_ref: Counter = Counter()
            for r in refs:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            guess[n - 1] += max(0, len(hyp) - n + 1)
            correct[n - 1] += sum(min(c, max_ref[ng]) for ng, c in hyp_ng.items())

    bleus: List[float] = []
    logp = 0.0
    ratio = (testlen + tiny) / (reflen + small)
    bp = math.exp(1 - 1 / ratio) if ratio < 1 else 1.0
    for n in range(max_n):
        logp += math.log((correct[n] + tiny) / (guess[n] + small))
        bleus.append(math.exp(logp / (n + 1)) * bp)
    return bleus


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(cur[j], prev[j + 1]))
        prev = cur
    return prev[-1]


def rouge_l_corpus(gts: Dict[str, List[List[str]]], res: Dict[str, List[str]],
                   beta: float = 1.2) -> float:
    """Mean per-segment ROUGE-L F (MS-COCO Rouge: beta=1.2, max over refs)."""
    scores = []
    for key, hyp in res.items():
        best = 0.0
        for ref in gts[key]:
            lcs = _lcs_len(hyp, ref)
            p = lcs / len(hyp) if hyp else 0.0
            r = lcs / len(ref) if ref else 0.0
            f = ((1 + beta ** 2) * p * r / (r + beta ** 2 * p)
                 if p > 0 and r > 0 else 0.0)
            best = max(best, f)
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


# Vendored synonym table for METEOR's third alignment stage: symmetric
# groups (every word in a group is a synonym of every other). A deliberately
# minimal, radiology-focused subset of WordNet-style synonymy — the full
# WordNet corpus data is unavailable offline, and the METEOR-1.5 jar the
# reference calls additionally carries paraphrase tables. Curated for terms
# that genuinely alternate in MIMIC-CXR findings text; extend via the
# `synonyms=` argument of meteor_corpus. Multi-word lemmas are excluded by
# construction (METEOR drops them: lemma names containing '_').
METEOR_SYNONYM_GROUPS: List[List[str]] = [
    ["edema", "oedema"],
    ["opacity", "opaqueness", "opacification"],
    ["x-ray", "xray", "radiograph", "film"],
    ["heart", "cardiac"],
    ["lung", "pulmonary"],
    ["chest", "thorax", "thoracic"],
    ["normal", "unremarkable"],
    ["stable", "unchanged"],
    ["seen", "visualized", "observed", "noted", "identified", "demonstrated"],
    ["small", "little"],
    ["large", "big"],
    ["mild", "slight"],
    ["severe", "marked"],
    ["effusion", "fluid"],
    ["fracture", "break"],
    ["catheter", "line"],
    ["vasculature", "vascularity"],
    ["enlargement", "enlarged", "cardiomegaly"],
]


def _build_synonyms(groups: Iterable[Iterable[str]]) -> Dict[str, frozenset]:
    """Symmetric word -> synonym-set lookup. Each group is closed under
    Porter stemming because the synonym stage (like nltk meteor_score's)
    sees the STEMMED leftovers of the stem stage — surface-only entries
    would never fire."""
    stem = PorterStemmer().stem
    table: Dict[str, set] = {}
    for group in groups:
        g = set(group) | {stem(w) for w in group}
        for w in g:
            table.setdefault(w, set()).update(g)
    return {w: frozenset(s) for w, s in table.items()}


METEOR_SYNONYMS: Dict[str, frozenset] = _build_synonyms(METEOR_SYNONYM_GROUPS)


def meteor_corpus(gts: Dict[str, List[List[str]]], res: Dict[str, List[str]],
                  synonyms: Optional[Dict[str, frozenset]] = None) -> float:
    """Mean per-segment METEOR (exact + Porter-stem + synonym stages)."""
    if synonyms is None:
        synonyms = METEOR_SYNONYMS
    scores = [_meteor_segment(gts[key], hyp, synonyms=synonyms)
              for key, hyp in res.items()]
    return sum(scores) / max(len(scores), 1)


def _meteor_segment(refs: List[List[str]], hyp: List[str],
                    alpha: float = 0.9, beta: float = 3.0,
                    gamma: float = 0.5,
                    synonyms: Optional[Dict[str, frozenset]] = None) -> float:
    """METEOR for one segment, max over references (Lavie-Agarwal 2007,
    the defaults nltk uses): F_mean = PR/(αP+(1-α)R), fragmentation penalty
    γ·(chunks/matches)^β, zero on no matches."""
    stemmer = PorterStemmer()
    if synonyms is None:
        synonyms = METEOR_SYNONYMS
    best = 0.0
    for ref in refs:
        if not hyp or not ref:
            continue
        align = _align(hyp, ref, stemmer, synonyms)
        m = len(align)
        if m == 0:
            continue
        p, r = m / len(hyp), m / len(ref)
        fmean = p * r / (alpha * p + (1 - alpha) * r)
        chunks = _chunk_count(sorted(align))
        penalty = gamma * (chunks / m) ** beta
        best = max(best, fmean * (1 - penalty))
    return best


def _match_stage(hyp_items: List[tuple], ref_items: List[tuple],
                 syn_fn=None) -> tuple:
    """One alignment stage with nltk meteor_score's tie-breaking: scan the
    hypothesis back-to-front and pair each word with the LATEST still-unused
    reference position that matches (surface equality, or membership in the
    hypothesis word's synonym set when syn_fn is given). Items are
    (original_index, key) pairs; returns (matches, leftover_hyp,
    leftover_ref) exactly like nltk's _match_enums/_enum_wordnetsyn_match."""
    ref_positions: Dict[str, List[int]] = {}
    for j, (_, rk) in enumerate(ref_items):
        ref_positions.setdefault(rk, []).append(j)
    matched_h: set = set()
    matched_r: set = set()
    pairs: List[tuple] = []
    for i in range(len(hyp_items) - 1, -1, -1):
        word = hyp_items[i][1]
        keys = syn_fn(word) if syn_fn is not None else (word,)
        best_j, best_key = -1, None
        for k in keys:
            positions = ref_positions.get(k)
            if positions and positions[-1] > best_j:
                best_j, best_key = positions[-1], k
        if best_key is not None:
            ref_positions[best_key].pop()
            matched_h.add(i)
            matched_r.add(best_j)
            pairs.append((hyp_items[i][0], ref_items[best_j][0]))
    hyp_left = [it for i, it in enumerate(hyp_items) if i not in matched_h]
    ref_left = [it for j, it in enumerate(ref_items) if j not in matched_r]
    return pairs, hyp_left, ref_left


def _align(hyp: Sequence[str], ref: Sequence[str], stemmer,
           synonyms: Dict[str, frozenset]) -> List[tuple]:
    """(hyp_idx, ref_idx) alignment: exact, then Porter stem on the
    leftovers, then synonym match on the remaining leftovers — bit-identical
    to nltk _enum_align_words given the same synonym data."""
    hyp_items = list(enumerate(hyp))
    ref_items = list(enumerate(ref))
    exact, hyp_items, ref_items = _match_stage(hyp_items, ref_items)
    stem, hyp_left, ref_left = _match_stage(
        [(i, stemmer.stem(w)) for i, w in hyp_items],
        [(j, stemmer.stem(w)) for j, w in ref_items])
    # the synonym stage sees the STEMMED leftovers — nltk passes
    # _enum_stem_match's leftover lists (stemmed keys) straight into
    # _enum_wordnetsyn_match; METEOR_SYNONYMS groups are stem-closed so the
    # lookup still fires
    syn_fn = lambda w: synonyms.get(w, frozenset((w,))) | {w}
    syn, _, _ = _match_stage(hyp_left, ref_left, syn_fn=syn_fn)
    return exact + stem + syn


def _chunk_count(align_sorted: List[tuple]) -> int:
    """Number of maximal monotonic contiguous runs in the alignment."""
    chunks = 0
    prev = None
    for hi, ri in align_sorted:
        if prev is None or hi != prev[0] + 1 or ri != prev[1] + 1:
            chunks += 1
        prev = (hi, ri)
    return chunks


class NLGScores(NamedTuple):
    bleu1: float
    bleu2: float
    bleu3: float
    bleu4: float
    meteor: float
    rouge_l: float

    @property
    def agg_metrics(self) -> float:
        return sum(self) / len(self)

    def as_dict(self) -> Dict[str, float]:
        d = {"Bleu_1": self.bleu1, "Bleu_2": self.bleu2, "Bleu_3": self.bleu3,
             "Bleu_4": self.bleu4, "METEOR": self.meteor, "ROUGE_L": self.rouge_l}
        d["agg_metrics"] = self.agg_metrics
        return d


def evaluate_reports(predictions: Dict[str, str], references: Dict[str, str]) -> NLGScores:
    """The MIMICEvalCap contract: id -> generated findings vs id -> GT
    findings. Both sides tokenized + lowercased identically."""
    if set(predictions) != set(references):
        raise ValueError("prediction and reference ids differ")
    res = {k: tokenize_report(v) for k, v in predictions.items()}
    gts = {k: [tokenize_report(v)] for k, v in references.items()}
    b1, b2, b3, b4 = corpus_bleu(gts, res)
    return NLGScores(b1, b2, b3, b4, meteor_corpus(gts, res),
                     rouge_l_corpus(gts, res))
