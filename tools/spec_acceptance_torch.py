#!/usr/bin/env python3
"""Prompt-lookup acceptance on realistic (non-degenerate) correction
transcripts: the PyTorch port of tools/spec_acceptance.py, a host simulator
of the speculative engine over the port's drafter.

What a user gets from speculative decoding on the automated-correction pass
depends on how much of the true output is findable in the prompt: a
property of the drafter and the text alone, not of the weights. So:

  prompt  = the Vicuna system prompt + the report-generation instruction +
            a generated report + the byte-exact correction turn
            (``data/downstream.py correction_prompt``);
  output  = the corrected report: the false-positive sentence removed, the
            false-negative one added, the other sentences verbatim.

The simulation runs the port's drafter (``decode/speculative.py
ngram_propose``, on ``--device``) under teacher forcing: with greedy
decoding the model's token after a correctly accepted prefix IS the true
output token, so counting accepted drafts needs no model. The engine's
writes past the accepted point (the model's predictions under a rejected
context) are unknowable, and bracketed:

  opt   they coincide with the true continuation (acceptance upper bound);
  pess  they are junk that never matches (lower bound).

When no draft reads past the live length (``stale_read_iters`` 0), both
equal the real engine's iteration count. Tokens are words and punctuation
(no Vicuna tokenizer is in the repository).

One JSON line per workload ("correction": the output echoes the prompt;
"rg": report generation from findings keywords alone, the no-echo floor):
forwards and accepted tokens a forward for opt and pess, and the tokens/s
they imply at ``--ms-verify`` ms a (k+1)-token verify and ``--ms-plain`` ms a
1-token step. Those two defaults are the card's own, from
tools/bench_spec_torch.py's plain and oracle rows on an NVIDIA H100 80GB
HBM3 at 700 W (PERF.md); they are the only defaults that differ from the
JAX tool's, whose were a TPU's. The lines carry the JAX tool's keys only,
with no ``device`` or ``runs_s``: nothing is timed, and at the same flags
the output is byte for byte the JAX tool's.

Usage: python3 tools/spec_acceptance_torch.py [--k 5] [--m 3] [--n 24]
       [--ms-plain MS] [--ms-verify MS] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# the card's ms a 1-token decode step and a (k+1)-token verify at batch 1:
# tools/bench_spec_torch.py at its defaults (k 5, a 448-token prompt, 300
# tokens, the bf16 cache), the plain and oracle rows' ms_per_forward on an
# NVIDIA H100 80GB HBM3 at 700.00 W
MS_PLAIN, MS_VERIFY = 80.65, 89.36

# Realistic per-finding report sentences (MIMIC-CXR phrasing style; the
# fixture corpus in tests/fixtures/sectioned.csv uses the same register but
# is too short for 256-token correction turns).
FINDING_SENTENCES: Dict[str, str] = {
    "Cardiomegaly": ("The cardiac silhouette is enlarged, stable in "
                     "appearance compared to the prior examination."),
    "Edema": ("There is mild interstitial pulmonary edema with perihilar "
              "haziness and vascular indistinctness."),
    "Pneumonia": ("Patchy right lower lobe opacity is concerning for "
                  "pneumonia in the appropriate clinical setting."),
    "Pleural Effusion": ("Small bilateral pleural effusions are present, "
                         "slightly increased from the prior study."),
    "Atelectasis": ("Linear opacities at the left base are most consistent "
                    "with subsegmental atelectasis."),
    "Pneumothorax": ("There is a small right apical pneumothorax without "
                     "evidence of tension."),
    "Consolidation": ("Focal consolidation is identified in the lingula, "
                      "which may represent aspiration or infection."),
    "Lung Opacity": ("Diffuse bilateral hazy opacities are again "
                     "demonstrated, grossly unchanged."),
    "Fracture": ("There is an acute displaced fracture of the left fifth "
                 "posterior rib."),
    "Support Devices": ("An endotracheal tube terminates approximately 4 cm "
                        "above the carina; a nasogastric tube courses below "
                        "the diaphragm."),
}
BASE_SENTENCES = [
    "The lungs are otherwise clear without focal consolidation.",
    "No pneumothorax is identified on the current examination.",
    "The mediastinal and hilar contours are within normal limits.",
    "The visualized osseous structures are intact.",
    "Degenerative changes are noted in the thoracic spine.",
    "The upper abdomen is unremarkable on the included views.",
]
SYSTEM = ("A chat between a curious user and an artificial intelligence "
          "assistant. The assistant gives helpful, detailed, and polite "
          "answers to the user's questions.")
RG_INSTRUCTION = ("Image information: " + "<IMG>" * 32 +
                  ". Predicted Findings: {findings}. You are to act as a "
                  "radiologist and write the finding section of a chest "
                  "x-ray radiology report for this X-ray image given the "
                  "predicted findings. Write in the style of a professional "
                  "radiology report.")

_TOKEN_RE = re.compile(r"\w+|[^\w\s]")


def tokenize(text: str, vocab: Dict[str, int]) -> np.ndarray:
    ids = [vocab.setdefault(w, len(vocab) + 3) for w in _TOKEN_RE.findall(text)]
    return np.asarray(ids, np.int32)


def make_transcript(rng: np.random.Generator,
                    vocab: Dict[str, int]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One correction study -> (prompt ids, corrected-output ids, rg ids)."""
    from radialog_tpu_torch.data.downstream import correction_prompt

    names = list(FINDING_SENTENCES)
    present = sorted(rng.choice(len(names), size=4, replace=False))
    fp_name = names[present[0]]                  # predicted, not actually there
    fn_name = names[[i for i in range(len(names)) if i not in present][0]]
    report_sents = [FINDING_SENTENCES[names[i]] for i in present]
    base = list(rng.choice(BASE_SENTENCES, size=3, replace=False))
    order = rng.permutation(len(report_sents) + len(base))
    sents = (report_sents + base)
    report = " ".join(sents[i] for i in order)

    corrected = [s for s in sents if s != FINDING_SENTENCES[fp_name]]
    corrected.append(FINDING_SENTENCES[fn_name])
    corrected_report = " ".join(corrected)

    findings = ", ".join(names[i].lower() for i in present)
    turn = correction_prompt([fp_name], [fn_name])
    prompt = (SYSTEM + " USER: " + RG_INSTRUCTION.format(findings=findings) +
              " ASSISTANT: " + report + "</s>USER: " + turn + " ASSISTANT:")
    return (tokenize(prompt, vocab), tokenize(corrected_report, vocab),
            tokenize(report, vocab))


def simulate(prompt: np.ndarray, output: np.ndarray, k: int, m: int,
             optimistic: bool, device="cpu") -> Dict[str, int]:
    """Teacher-forced run of the engine's speculative loop over the port's
    drafter (decode/speculative.py ``spec_decode_loop``): c counts emitted
    tokens (token 0 comes from the prefill forward); each iteration drafts
    k, accepts the longest true-prefix match, emits accepted + 1 and writes
    the whole (k+1) block into the history. ``stale_reads`` counts the
    iterations whose draft slice ran past the live length; where it is 0,
    opt and pess are the real engine's behavior."""
    import torch
    from radialog_tpu_torch.decode.speculative import ngram_propose

    pl, n = len(prompt), len(output)
    hist = np.full(pl + n + k + 1, -1, np.int32)
    hist[:pl] = prompt
    hist[pl] = output[0]

    c, iters, stale_reads = 1, 0, 0
    while c < n:
        hl = pl + c
        draft = ngram_propose(torch.from_numpy(hist).to(device), hl, k=k, m=m).cpu().numpy()
        true = output[c:c + k]
        acc = 0
        while acc < len(true) and draft[acc] == true[acc]:
            acc += 1
        emit = min(acc + 1, n - c)
        # the engine writes all k+1 block outputs; entries past `emit` are
        # the model's off-path predictions, unknowable here -> bracket
        blk_end = min(pl + c + k + 1, len(hist))
        if optimistic:
            span = output[c:c + (blk_end - (pl + c))]
            hist[pl + c:pl + c + len(span)] = span
        else:
            hist[pl + c:pl + c + emit] = output[c:c + emit]
            hist[pl + c + emit:blk_end] = -1
        # did the drafter read past the live region this step? (start < 0:
        # the no-match fallback, which repeats the last live token)
        start = _draft_start(hist, hl, k, m)
        if start >= 0 and start + k > hl:
            stale_reads += 1
        c += emit
        iters += 1
    return {"iters": iters, "forwards": iters + 1, "out_tokens": n,
            "stale_reads": stale_reads}


def _draft_start(hist: np.ndarray, hl: int, k: int, m: int) -> int:
    """Where ngram_propose's draft slice starts (a host mirror, for the
    stale_reads count only); -1 for the no-match fallback."""
    if hl <= m:
        return -1
    pattern = hist[hl - m:hl]
    best = -1
    for i in range(hl - m):
        if (hist[i:i + m] == pattern).all():
            best = i
    if best < 0:
        return -1
    return min(max(best + m, 0), len(hist) - k)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--m", type=int, default=3)
    ap.add_argument("--n", type=int, default=24, help="transcripts")
    ap.add_argument("--ms-plain", type=float, default=MS_PLAIN,
                    help="ms per 1-token forward: the plain row of "
                         "tools/bench_spec_torch.py on an NVIDIA H100 80GB HBM3, 700.00 W")
    ap.add_argument("--ms-verify", type=float, default=MS_VERIFY,
                    help="ms per (k+1)-token verify forward: the oracle row of "
                         "tools/bench_spec_torch.py on an NVIDIA H100 80GB HBM3, 700.00 W")
    ap.add_argument("--device", default="cuda", help="where the drafter runs")
    return ap


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    args = build_parser().parse_args(argv)
    from tools.bench_torch import open_device
    dev = open_device(args.device)
    rng = np.random.default_rng(0)
    vocab: Dict[str, int] = {}
    studies = [make_transcript(rng, vocab) for _ in range(args.n)]
    lines = []
    for task, pairs in (
            ("correction", [(p, y) for p, y, _ in studies]),
            ("rg", [(tokenize(SYSTEM + " USER: ", vocab), y) for _, _, y in studies])):
        rows = {v: [simulate(p, y, args.k, args.m, optimistic=(v == "opt"), device=dev)
                    for p, y in pairs] for v in ("opt", "pess")}
        out_tok = float(np.mean([r["out_tokens"] for r in rows["pess"]]))
        rec: Dict[str, object] = {"task": task, "k": args.k, "m": args.m, "n": args.n,
                                  "mean_out_tokens": round(out_tok, 1)}
        for v in ("opt", "pess"):
            fw = float(np.mean([r["forwards"] for r in rows[v]]))
            acc = float(np.mean([r["out_tokens"] / r["forwards"] for r in rows[v]]))
            tok_s = 1e3 * acc / args.ms_verify
            rec[v] = {"forwards": round(fw, 1),
                      "accepted_per_forward": round(acc, 2),
                      "implied_tok_s": round(tok_s, 1),
                      "stale_read_iters": int(sum(r["stale_reads"] for r in rows[v]))}
        rec["plain_tok_s"] = round(1e3 / args.ms_plain, 1)
        print(json.dumps(rec))
        lines.append(rec)
    return lines


if __name__ == "__main__":
    main()
