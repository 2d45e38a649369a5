"""Follow-up question passes of the evaluation (port of
radialog_tpu/apps/evaluate.py: ``EvalOptions``, ``run_binary_qa_pass``,
``run_all_qa_pass``).

Each pass continues the decoded conversation of the report pass
(``preds_history``: prompt + generated report) with a question and scores
the parsed answers against the ground-truth labels with the CE metrics.
The batch shapes are the reference's: the binary pass asks the 14 finding
questions of one study as one batch (10 new tokens), so every lane carries
the same image and the whole history joins the shared prefix; the all-QA
pass asks one question per study in batches of 5 (30 new tokens).

Not ported yet: ``run_eval`` (the report pass with its NLG scores and
CSVs) and the correction pass.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.downstream import (all_qa_parse, all_qa_prompt, binary_qa_no_finding_fixup,
                               binary_qa_parse, binary_qa_prompts)
from ..eval.ce_metrics import CHEXPERT_COLS, ce_metrics
from .pipeline import RaDialogPipeline

ALL_QA_BATCH = 5
EmbProvider = Callable[[Sequence[str]], object]   # dicoms -> (N, 32, 768) embeddings


@dataclasses.dataclass
class EvalOptions:
    """The options the ported passes read; the report pass's (batch size,
    sampling, output paths) come with it."""
    use_embs: bool = False


def _embs(pipe: RaDialogPipeline, opts: EvalOptions, emb_provider: Optional[EmbProvider],
          dicoms: Sequence[str]) -> Optional[torch.Tensor]:
    if not (opts.use_embs and emb_provider):
        return None
    return torch.as_tensor(emb_provider(list(dicoms)), device=pipe.device)


def run_binary_qa_pass(pipe: RaDialogPipeline, records: List[Dict], preds_history: List[str],
                       gt_labels: np.ndarray, opts: EvalOptions,
                       emb_provider: Optional[EmbProvider]) -> Dict[str, float]:
    """14 yes/no questions per report, max_new_tokens 10."""
    preds = []
    for i, hist in enumerate(preds_history):
        prompts = binary_qa_prompts(hist, CHEXPERT_COLS)
        embs = _embs(pipe, opts, emb_provider, [records[i]["dicom"]])
        if embs is not None:
            embs = embs.repeat(len(prompts), 1, 1)
        decoded = pipe.generate_texts(prompts, img_embs=embs, max_new_tokens=10)
        preds.append([binary_qa_parse(d) for d in decoded])
    preds = binary_qa_no_finding_fixup(np.asarray(preds), CHEXPERT_COLS)
    ce = ce_metrics(gt_labels, preds.astype(np.float64))
    return {f"bin_qa_{k}": v for k, v in ce.items() if not isinstance(v, list)}


def run_all_qa_pass(pipe: RaDialogPipeline, records: List[Dict], preds_history: List[str],
                    gt_labels: np.ndarray, opts: EvalOptions,
                    emb_provider: Optional[EmbProvider]) -> Dict[str, float]:
    """'List all the findings', batches of 5, max_new_tokens 30."""
    prompts = [all_qa_prompt(h) for h in preds_history]
    preds: List[List[int]] = []
    for i0 in range(0, len(prompts), ALL_QA_BATCH):
        chunk = prompts[i0:i0 + ALL_QA_BATCH]
        embs = _embs(pipe, opts, emb_provider,
                     [r["dicom"] for r in records[i0:i0 + ALL_QA_BATCH]])
        decoded = pipe.generate_texts(chunk, img_embs=embs, max_new_tokens=30)
        preds.extend(all_qa_parse(d, CHEXPERT_COLS) for d in decoded)
    ce = ce_metrics(gt_labels, np.asarray(preds, np.float64))
    return {f"all_qa_{k}": v for k, v in ce.items() if not isinstance(v, list)}
