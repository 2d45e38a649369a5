"""Follow-up turns of the evaluation passes (port of
radialog_tpu/data/downstream.py): the correction turn built from each
report's false-positive and false-negative findings, the binary and
all-findings QA prompts, and the parsing of their answers."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

KEEP_OLD = "KEEP_OLD"


def _and_join(names: List[str]) -> str:
    s = ", ".join(names)
    return " and ".join(s.rsplit(", ", 1))


def fp_fn_lists(col_names: Sequence[str], pred_labels: np.ndarray,
                gt_labels: np.ndarray) -> Tuple[List[List[str]], List[List[str]]]:
    """Per-report false-positive and false-negative finding names, 'No
    Finding' excluded."""
    fp_mat = pred_labels * (1 - gt_labels)
    fn_mat = (1 - pred_labels) * gt_labels
    all_fps, all_fns = [], []
    for fp_row, fn_row in zip(fp_mat, fn_mat):
        all_fps.append([col_names[i] for i, v in enumerate(fp_row)
                        if v == 1 and col_names[i] != "No Finding"])
        all_fns.append([col_names[i] for i, v in enumerate(fn_row)
                        if v == 1 and col_names[i] != "No Finding"])
    return all_fps, all_fns


def correction_prompt(fp: List[str], fn: List[str]) -> str:
    """One follow-up instruction; KEEP_OLD when the report needs no
    correction."""
    fp_str, fn_str = _and_join(fp).lower(), _and_join(fn).lower()
    if fp and fn:
        return (f"Please adapt the report with the following corrections: "
                f"Include {fn_str} and remove {fp_str}. Don't make other changes.")
    if fp:
        return (f"The patient does not have {fp_str}. Update the report. "
                f"Don't make other changes.")
    if fn:
        return (f"The patient also has {fn_str}, correct the report. "
                f"Don't make other changes.")
    return KEEP_OLD


def correction_prompts(preds_history: List[str], col_names: Sequence[str],
                       pred_labels: np.ndarray, gt_labels: np.ndarray) -> List[str]:
    """The correction turn after each decoded conversation: '...ASSISTANT:
    <report></s>USER: <correction> ASSISTANT:'."""
    fps, fns = fp_fn_lists(col_names, pred_labels, gt_labels)
    out = []
    for hist, fp, fn in zip(preds_history, fps, fns):
        hist = hist.replace("ASSISTANT:", "ASSISTANT: ")
        out.append(hist + "</s>USER: " + correction_prompt(fp, fn) + " ASSISTANT:")
    return out


def correction_extract(decoded: str, prompt: str) -> str:
    """The corrected report; a KEEP_OLD turn keeps the original report."""
    if KEEP_OLD in prompt:
        return prompt.split(f"</s>USER: {KEEP_OLD}")[0].split("ASSISTANT:")[-1].strip()
    return decoded.split("ASSISTANT:")[-1].strip()


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
