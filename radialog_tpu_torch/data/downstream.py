"""Follow-up question prompts of the evaluation passes and the parsing of
their answers (port of the QA helpers of radialog_tpu/data/downstream.py;
the correction helpers come with the correction pass)."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def binary_qa_prompts(pred_history: str, col_names: Sequence[str]) -> List[str]:
    """One 'Is there any <X>?' follow-up per finding, after the decoded
    conversation."""
    hist = pred_history.replace("ASSISTANT:", "ASSISTANT: ")
    return [hist + "</s>USER:  Is there any " + c + "? ASSISTANT:" for c in col_names]


def binary_qa_parse(decoded: str) -> int:
    """'yes' in the answer -> positive."""
    return 1 if "yes" in decoded.split("ASSISTANT:")[-1].lower() else 0


def binary_qa_no_finding_fixup(preds: np.ndarray, col_names: Sequence[str]) -> np.ndarray:
    """'No Finding' is the complement of any other positive answer."""
    preds = np.asarray(preds).copy()
    nf = list(col_names).index("No Finding")
    others = [i for i in range(len(col_names)) if i != nf]
    any_f = (preds[:, others].sum(axis=1) > 0).astype(preds.dtype)
    preds[:, nf] = 1 - any_f
    return preds


def all_qa_prompt(pred_history: str) -> str:
    """The 'List all the findings in this report.' follow-up."""
    hist = pred_history.replace("ASSISTANT:", "ASSISTANT: ")
    return hist + "</s>USER: List all the findings in this report. ASSISTANT:"


def all_qa_parse(decoded: str, col_names: Sequence[str]) -> List[int]:
    """Finding names found in the answer -> one-hot over col_names."""
    answer = decoded.split("ASSISTANT:")[-1].lower()
    return [1 if c.lower() in answer else 0 for c in col_names]
